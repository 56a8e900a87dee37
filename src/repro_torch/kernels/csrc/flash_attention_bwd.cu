// Softmax attention backward, causal or bidirectional, with grouped KV heads:
// given q, k, v, the forward's output o and its rows' log-sum-exp lse, and
// the output's gradient do, computes
//   P   = exp(q k^T * scale - lse)            (0 where the mask hides a key)
//   dV  = sum over the group's heads of P^T do
//   dS  = P * (do v^T - D),  D = rowsum(do * o)
//   dQ  = dS k * scale,  dK = sum over the group's heads of dS^T q * scale
// with scale = dh^-0.5 and the forward's bottom-right causal alignment
// (query i sees key j iff j <= i + (skv - sq)).  q, o, do, dq are
// (b, sq, H, dh), k, v, dk, dv (b, skv, KV, dh), all contiguous; lse is
// float32 (b, H, sq).  dh 32, 64 or 128, any sq and skv.  No atomics: two
// launches give the same bits.  Hand-written for Hopper (sm_90a).
//
// Which kernels serve which dtype:
//   * bfloat16 (flash_attention_bwd_bf16, the training path): the wgmma
//     kernels of the second half of this file, for every dh.
//   * float32 (flash_attention_bwd_f32, the reduced models' card-vs-host
//     checks): the SIMT kernels of the first half.  TF32 tensor cores
//     would keep ~3 digits, short of the 1e-4 those checks hold.
//
// Replaces: no TPU kernel.  The reference trains through jax.value_and_grad
// over its jnp attention (src/repro/train/step.py:52-55) and has no
// backward for its Pallas forward (src/repro/kernels/flash_attention.py:68);
// the port's forward is this repository's kernel, so its gradient is one
// too (kernels/flash_attention.py, FlashAttentionFn).
//
// Bound: operations.  10 dh flops a visible (query, key) pair and head (the
// products q k^T, do v^T, P^T do, dS^T q and dS k); at glm4-9b's training
// shape (b 4, s 1024, H 32, KV 2, dh 128, causal) 86.0 GFLOP, 0.087 ms at
// the bf16 tensor cores' 989 TFLOP/s.  Only wgmma reaches that rate.  The
// split below recomputes S and do v^T for dQ: 14 dh flops a pair, so at
// best 71 % of the bound.
//
// Design, bfloat16, after FlashAttention-3's backward:
//   * Three launches, four with split > 1.  A prep pass writes lse * log2e
//     and D = rowsum(do * o) in float32, rows padded to 128 (a padding row
//     gets lse2 = +inf, so its P is 0).  A dK/dV kernel takes one CTA per
//     (key tile of 128, KV head, batch, part of the split): it keeps its K
//     and V resident and walks its part of the (group head, query tile of
//     64) pairs that see its keys.  With split 1 it writes dK and dV; else
//     float32 partials that a reduction sums in a fixed order.  A dQ
//     kernel takes one CTA per (query tile of 128, head, batch) and walks
//     the key tiles of 64 its rows see.  The wrapper's plan
//     (kernels/flash_attention.py, bwd_plan) chooses split from the SM
//     count: enough CTAs to fill the card twice over.
//   * Warp specialisation as in the forward: warpgroup 0 hands its
//     registers over (setmaxnreg 24) and one thread issues every TMA load
//     (4-D tensor maps, 128- or 64-byte swizzle; lse2 and D by bulk copy)
//     through a two-stage ring with full and empty mbarriers; warpgroups 1
//     and 2 consume (setmaxnreg 240), 64 keys (dK/dV) or 64 query rows (dQ)
//     each.  The helpers are hopper.cuh's.
//   * dK/dV computes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both
//     operands K-major in shared memory), so that P^T and dS^T are in
//     registers in the A-fragment layout: dV += P^T dO and dK += dS^T Q
//     read dO and Q MN-major from the same swizzled tiles.  lse2 and D are
//     per query, so per column: each step stages its 64 rows' in shared
//     memory.  dQ computes S = Q K^T and dP = dO V^T the same way, and
//     dQ += dS K with K read MN-major.  Nothing goes through shared memory
//     between the products.
//   * P and dS are rounded to bf16 before their products (as FA-2/3 and
//     SDPA do); the accumulators, lse, D and the exponent stay float32, the
//     exponent one explicit fma (the library is built with --fmad=false)
//     and ex2.approx.
//   * Heaviest first: under the causal mask the first key tiles (dK/dV)
//     and the last query tiles (dQ) see the most pairs, and their CTAs
//     have the lowest indices.  The mask only on steps that cross the
//     diagonal (and, in dQ, skv: rows past it are TMA's zeros).
//
// Design, float32, after FlashAttention-2's backward, SIMT:
//   * Three launches.  A pre-pass computes D = rowsum(do * o) in float32, a
//     warp a row.  A dK/dV kernel takes one CTA per (key tile of 64, KV
//     head, batch) and keeps its K and V tile and its dK and dV sums
//     resident while it walks the qper query heads of its group and every
//     query tile of 64 rows that sees the key tile; a dQ kernel takes one
//     CTA per (query tile of 64, head, batch) and walks the key tiles its
//     rows see.  Each recomputes S and do v^T; nothing is reduced across
//     CTAs.
//   * 256 threads as 16 x 16; a thread owns a 4 x 4 micro-tile of S and
//     do v^T (rows ty + 16 i, keys tx + 16 j) and 4 rows x dh/16 columns of
//     each output (columns tx * VW + 16 VW g + e).  Tiles sit in shared
//     memory as float32 with a row stride of 4 mod 32 words, so that the
//     float4 reads of 8 neighbouring rows are conflict-free; P^T and dS^T
//     (dK/dV) or dS (dQ) are staged there for the output products.  Every
//     product is an explicit __fmaf_rn.
//   * The mask only on tiles that cross sq, skv or the diagonal; query
//     tiles above the diagonal are never visited.
#include <string.h>
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: SIMT (FlashAttention-2's backward)
// ---------------------------------------------------------------------------
constexpr int kTile = 64;              // query rows or keys of a tile
constexpr int kThreads = 256;          // 16 x 16
constexpr int kTS = kTile + 4;         // row stride of P^T, dS^T and dS

template <int DH>
struct BwdGeo {
  static constexpr int kS = DH + 4;               // row stride of a tile
  static constexpr int kTileF = kTile * kS;       // floats of a tile
  static constexpr int kOD = DH / 16;             // output columns a thread
  static constexpr int kVW = kOD < 4 ? kOD : 4;   // read / written at once
  static constexpr int kGroups = kOD / kVW;
  // four (64 x DH) tiles, one or two (64 x 64) tiles, lse and D of 64 rows
  static constexpr int kSmemDkdv = 4 * (4 * kTileF + 2 * kTile * kTS + 128);
  static constexpr int kSmemDq = 4 * (4 * kTileF + kTile * kTS + 128);
};

__device__ __forceinline__ float to_f(float v) { return v; }

// 16 bytes of a row: 4 floats
__device__ __forceinline__ void load16(float* dst, const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
}

// VW consecutive outputs of a row
template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}

// rows row0 .. row0 + 63 of one head of a contiguous (b, s, heads, DH)
// tensor (src points at its batch and head; rows are `rs` elements apart)
// into a (64 x DH) float32 tile; rows past s are zeros
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int row0, int s) {
  constexpr int kE = 16 / sizeof(T);            // elements of 16 bytes
  constexpr int kPerRow = DH / kE;
  constexpr int kIters = kTile * kPerRow / kThreads;
  static_assert(kIters * kThreads == kTile * kPerRow, "tile loads");
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / kPerRow, c = (e % kPerRow) * kE;
    float v[kE];
    if (row0 + r < s) {
      load16(v, src + (row0 + r) * rs + c);
    } else {
#pragma unroll
      for (int i = 0; i < kE; ++i) v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kE; i += 4)
      *reinterpret_cast<float4*>(dst + r * BwdGeo<DH>::kS + c + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

__device__ __forceinline__ void lds4(float* dst, const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
}
template <int W>
__device__ __forceinline__ void ldsw(float* dst, const float* src) {
  if constexpr (W == 4) {
    lds4(dst, src);
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d] over two (64 x DH) tiles
template <int DH>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int S = BwdGeo<DH>::kS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lds4(av[i], a + (ty + 16 * i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) lds4(bv[j], b + (tx + 16 * j) * S + d);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = __fmaf_rn(av[i][dd], bv[j][dd], s[i][j]);
  }
}

// acc[i][c] += sum_r a[ty + 16 i][r] b[r][col(c)] over a (64 x 64) tile a
// (stride kTS) and a (64 x DH) tile b, col(c) = 16 VW g + tx VW + e for
// c = g VW + e
template <int DH>
__device__ __forceinline__ void tile_acc(float (&acc)[4][BwdGeo<DH>::kOD],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  using G = BwdGeo<DH>;
  constexpr int VW = G::kVW;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lds4(av[i], a + (ty + 16 * i) * kTS + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float bv[G::kOD];
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g)
        ldsw<VW>(bv + g * VW, b + (r + rr) * G::kS + g * 16 * VW + tx * VW);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < G::kOD; ++c)
          acc[i][c] = __fmaf_rn(av[i][rr], bv[c], acc[i][c]);
    }
  }
}

// rows row0 + ty + 16 i (< n) of a contiguous (.., n, heads, DH) output
// (dst at its batch and head, rows `rs` apart): acc * mul
template <typename T, int DH>
__device__ __forceinline__ void store_rows(
    T* dst, long long rs, int row0, int n,
    const float (&acc)[4][BwdGeo<DH>::kOD], float mul, int ty, int tx) {
  using G = BwdGeo<DH>;
  constexpr int VW = G::kVW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int g = 0; g < G::kGroups; ++g) {
      float v[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) v[e] = acc[i][g * VW + e] * mul;
      store_vec<VW>(dst + row * rs + g * 16 * VW + tx * VW, v);
    }
  }
}

// P and dS of one (query tile, key tile) pair from S = q k^T and
// dp = do v^T: P = exp2(S scale_log2 - lse log2e), 0 where hidden
__device__ __forceinline__ void softmax_grad(
    float (&s)[4][4], float (&dp)[4][4], const float* lse2, const float* dsum,
    int q0, int key0, int sq, int skv, int causal, float scale_log2, int ty,
    int tx) {
  const int off = skv - sq;
  const bool edge = q0 + kTile > sq || key0 + kTile > skv ||
                    (causal && key0 + kTile - 1 > q0 + off);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + tx + 16 * j;
      const bool hidden = edge && (row >= sq || key >= skv ||
                                   (causal && key > row + off));
      const float p =
          hidden ? 0.0f : exp2f(__fmaf_rn(s[i][j], scale_log2, -lse2[r]));
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dsum[r]);
    }
  }
}

// lse (in log2 units) and D of rows q0 .. q0 + 63 into shared memory
__device__ __forceinline__ void load_rows(float* lse2, float* dsum,
                                          const float* lse, const float* d,
                                          int q0, int sq) {
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse2[threadIdx.x] = row < sq ? lse[row] * kLog2e : 0.0f;
    dsum[threadIdx.x] = row < sq ? d[row] : 0.0f;
  }
}

// D[b, h, i] = sum_d do[b, i, h, d] o[b, i, h, d], a warp a row
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ dsum, long long rows, int sq, int H) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;                  // whole warps leave together
  const T* orow = o + w * DH;
  const T* grow = dout + w * DH;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < DH; d += 32)
    acc = __fmaf_rn(to_f(grow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    const long long h = w % H, i = (w / H) % sq;
    const long long b = w / (static_cast<long long>(H) * sq);
    dsum[(b * H + h) * sq + i] = acc;
  }
}

// one CTA per (key tile, KV head, batch): dK and dV of its 64 keys over the
// group's heads and every query tile that sees them
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dk,
                   T* __restrict__ dv, int sq, int skv, int H, int KV,
                   int causal, float scale, float scale_log2) {
  using G = BwdGeo<DH>;
  extern __shared__ float4 smem_f4[];
  float* sK = reinterpret_cast<float*>(smem_f4);
  float* sV = sK + G::kTileF;
  float* sQ = sV + G::kTileF;
  float* sO = sQ + G::kTileF;              // do
  float* sPT = sO + G::kTileF;             // P^T: key rows, query columns
  float* sDST = sPT + kTile * kTS;         // dS^T
  float* sL = sDST + kTile * kTS;          // lse * log2e of the query tile
  float* sD = sL + kTile;                  // D of the query tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int key0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int qper = H / KV, off = skv - sq;
  const long long krs = static_cast<long long>(KV) * DH;
  const long long qrs = static_cast<long long>(H) * DH;
  const long long kbase = static_cast<long long>(b) * skv * krs + kvh * DH;
  load_tile<T, DH>(sK, k + kbase, krs, key0, skv);
  load_tile<T, DH>(sV, v + kbase, krs, key0, skv);

  float adk[4][G::kOD], adv[4][G::kOD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::kOD; ++c) adk[i][c] = adv[i][c] = 0.0f;
  const int n_qt = (sq + kTile - 1) / kTile;
  // the first query tile with a row that sees key0
  const int qt0 = causal ? max(0, key0 - off) / kTile : 0;
  for (int hq = 0; hq < qper; ++hq) {
    const int h = kvh * qper + hq;
    const long long qbase = static_cast<long long>(b) * sq * qrs + h * DH;
    const long long rbase = (static_cast<long long>(b) * H + h) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();                 // the last tile's reads are done
      load_tile<T, DH>(sQ, q + qbase, qrs, q0, sq);
      load_tile<T, DH>(sO, dout + qbase, qrs, q0, sq);
      load_rows(sL, sD, lse + rbase, dsum + rbase, q0, sq);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<DH>(s, sQ, sK, ty, tx);
      tile_dot<DH>(dp, sO, sV, ty, tx);
      softmax_grad(s, dp, sL, sD, q0, key0, sq, skv, causal, scale_log2, ty,
                   tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sPT[(tx + 16 * j) * kTS + ty + 16 * i] = s[i][j];
          sDST[(tx + 16 * j) * kTS + ty + 16 * i] = dp[i][j];
        }
      __syncthreads();
      tile_acc<DH>(adv, sPT, sO, ty, tx);
      tile_acc<DH>(adk, sDST, sQ, ty, tx);
    }
  }
  store_rows<T, DH>(dk + kbase, krs, key0, skv, adk, scale, ty, tx);
  store_rows<T, DH>(dv + kbase, krs, key0, skv, adv, 1.0f, ty, tx);
}

// one CTA per (query tile, head, batch): dQ of its 64 rows over the key
// tiles they see
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, T* __restrict__ dq, int sq,
                 int skv, int H, int KV, int causal, float scale,
                 float scale_log2) {
  using G = BwdGeo<DH>;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);
  float* sO = sQ + G::kTileF;              // do
  float* sK = sO + G::kTileF;
  float* sV = sK + G::kTileF;
  float* sDS = sV + G::kTileF;             // dS: query rows, key columns
  float* sL = sDS + kTile * kTS;
  float* sD = sL + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), off = skv - sq;
  const long long krs = static_cast<long long>(KV) * DH;
  const long long qrs = static_cast<long long>(H) * DH;
  const long long kbase = static_cast<long long>(b) * skv * krs + kvh * DH;
  const long long qbase = static_cast<long long>(b) * sq * qrs + h * DH;
  const long long rbase = (static_cast<long long>(b) * H + h) * sq;
  load_tile<T, DH>(sQ, q + qbase, qrs, q0, sq);
  load_tile<T, DH>(sO, dout + qbase, qrs, q0, sq);
  load_rows(sL, sD, lse + rbase, dsum + rbase, q0, sq);

  float adq[4][G::kOD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::kOD; ++c) adq[i][c] = 0.0f;
  int kend = skv;                          // keys any row of the tile sees
  if (causal) kend = min(skv, q0 + kTile + off);
  const int n_kt = kend > 0 ? (kend + kTile - 1) / kTile : 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * kTile;
    __syncthreads();                   // the last tile's reads are done
    load_tile<T, DH>(sK, k + kbase, krs, key0, skv);
    load_tile<T, DH>(sV, v + kbase, krs, key0, skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DH>(s, sQ, sK, ty, tx);
    tile_dot<DH>(dp, sO, sV, ty, tx);
    softmax_grad(s, dp, sL, sD, q0, key0, sq, skv, causal, scale_log2, ty,
                 tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sDS[(ty + 16 * i) * kTS + tx + 16 * j] = dp[i][j];
    __syncthreads();
    tile_acc<DH>(adq, sDS, sK, ty, tx);
  }
  store_rows<T, DH>(dq + qbase, qrs, q0, sq, adq, scale, ty, tx);
}

template <typename T, int DH>
int launch(const T* q, const T* k, const T* v, const T* o, const float* lse,
           const T* dout, T* dq, T* dk, T* dv, float* dsum, int b, int sq,
           int skv, int H, int KV, int causal, cudaStream_t stream) {
  using G = BwdGeo<DH>;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const float scale_log2 = kLog2e * scale;
  const long long rows = static_cast<long long>(b) * sq * H;
  const long long warps_per_block = kThreads / 32;
  fa_bwd_dsum_kernel<T, DH>
      <<<static_cast<unsigned>((rows + warps_per_block - 1) / warps_per_block),
         kThreads, 0, stream>>>(o, dout, dsum, rows, sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kSmemDkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kSmemDq);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (skv > 0) {
    const dim3 grid_kv((skv + kTile - 1) / kTile, KV, b);
    fa_bwd_dkdv_kernel<T, DH><<<grid_kv, kThreads, G::kSmemDkdv, stream>>>(
        q, k, v, dout, lse, dsum, dk, dv, sq, skv, H, KV, causal, scale,
        scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_q((sq + kTile - 1) / kTile, H, b);
  fa_bwd_dq_kernel<T, DH><<<grid_q, kThreads, G::kSmemDq, stream>>>(
      q, k, v, dout, lse, dsum, dq, sq, skv, H, KV, causal, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* dq, void* dk, void* dv,
              void* dsum, int b, int sq, int skv, int H, int KV, int dh,
              int causal, void* stream) {
  if (b <= 0 || sq <= 0 || H <= 0 || KV <= 0 || H % KV) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* op = static_cast<const T*>(o);
  const auto* gp = static_cast<const T*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dqp = static_cast<T*>(dq);
  auto* dkp = static_cast<T*>(dk);
  auto* dvp = static_cast<T*>(dv);
  auto* dsp = static_cast<float*>(dsum);
  switch (dh) {
    case 32:
      return launch<T, 32>(qp, kp, vp, op, lp, gp, dqp, dkp, dvp, dsp, b, sq,
                           skv, H, KV, causal, s);
    case 64:
      return launch<T, 64>(qp, kp, vp, op, lp, gp, dqp, dkp, dvp, dsp, b, sq,
                           skv, H, KV, causal, s);
    case 128:
      return launch<T, 128>(qp, kp, vp, op, lp, gp, dqp, dkp, dvp, dsp, b,
                            sq, skv, H, KV, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles, warp-specialised (FlashAttention-3)
// ---------------------------------------------------------------------------
constexpr int kBwdConsumers = 2;                   // consumer warpgroups
constexpr int kBwdThreads = 128 * (kBwdConsumers + 1);
constexpr int kDkdvKeys = 64 * kBwdConsumers;      // keys of a dK/dV CTA
constexpr int kDkdvRows = 64;                      // query rows of a step
constexpr int kDkdvStages = 2;                     // Q/dO ring depth
constexpr int kDqRows = 64 * kBwdConsumers;        // query rows of a dQ CTA
constexpr int kDqKeys = 64;                        // keys of a K/V step
constexpr int kDqStages = 2;                       // K/V ring depth
constexpr int kRowPad = 128;                       // lse2 / D rows padded to
static_assert(kDkdvRows == 64 && kDqKeys == 64 && kRowPad % kDqRows == 0,
              "S and dP are m64n64k16 products");

// shared memory of a dK/dV CTA: K and V (kDkdvKeys rows each), the ring of
// Q and dO tiles, the ring of their rows' lse2 and D, then the barriers
template <int DH>
struct DkdvGeo : Swz<DH> {
  static constexpr int kKVBytes = kDkdvKeys * DH * 2;
  static constexpr int kQBytes = kDkdvRows * DH * 2;
  static constexpr int kRowBytes = kDkdvRows * 4;
  static constexpr int kSmem = 1024 + 2 * kKVBytes +
                               kDkdvStages * (2 * kQBytes + 2 * kRowBytes) +
                               8 * (1 + 2 * kDkdvStages);
};
// shared memory of a dQ CTA: Q and dO (kDqRows rows each), the ring of K
// and V tiles, then the barriers
template <int DH>
struct DqGeo : Swz<DH> {
  static constexpr int kQBytes = kDqRows * DH * 2;
  static constexpr int kKVBytes = kDqKeys * DH * 2;
  static constexpr int kSmem =
      1024 + 2 * kQBytes + kDqStages * 2 * kKVBytes + 8 * (1 + 2 * kDqStages);
};

// E (1, 2 or 4) consecutive bf16 as floats, in one load
template <int E>
__device__ __forceinline__ void load_bf16(float (&f)[E],
                                          const __nv_bfloat16* p) {
  if constexpr (E == 1) {
    f[0] = __bfloat162float(*p);
  } else {
    using V = typename std::conditional<E == 4, uint2, uint32_t>::type;
    const V v = *reinterpret_cast<const V*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < E / 2; ++j) {
      const float2 x = __bfloat1622float2(h[j]);
      f[2 * j] = x.x;
      f[2 * j + 1] = x.y;
    }
  }
}

// lse2[b, h, i] = lse * log2e and D[b, h, i] = sum_d do o over rows padded
// to kRowPad (b, H, sq_pad), a warp a row; a padding row gets lse2 = +inf
// and D = 0, so that its P, and so its dS, is 0
template <int DH>
__global__ void __launch_bounds__(256)
fa_bwd_prep_bf16_kernel(const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ lse2, float* __restrict__ dsum,
                        long long rows, int sq, int H, int sq_pad) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;                  // whole warps leave together
  const long long bh = w / sq_pad;
  const int i = static_cast<int>(w % sq_pad);
  if (i >= sq) {
    if (lane == 0) {
      lse2[w] = INFINITY;
      dsum[w] = 0.0f;
    }
    return;
  }
  // each lane DH / 32 consecutive elements of the row, in one load
  constexpr int kE = DH / 32;
  const long long at = (((bh / H) * sq + i) * H + bh % H) * DH + lane * kE;
  float fo[kE], fg[kE];
  load_bf16<kE>(fo, o + at);
  load_bf16<kE>(fg, dout + at);
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e) acc = __fmaf_rn(fg[e], fo[e], acc);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    lse2[w] = lse[bh * sq + i] * kLog2e;
    dsum[w] = acc;
  }
}

// acc (64 x 64) = A B over one warpgroup's 64 rows: A (64 rows at a,
// K-major, its column blocks `arows` rows apart) against B (64 rows at b,
// K-major), DH deep; issued and committed, not waited for.  The first
// k-step only writes acc.
template <int DH>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a,
                                         int arows, uint32_t b, int brows) {
  wgmma_fence();
  wgmma_ss_n64_set(acc, desc_k<DH>(a, arows, 0), desc_k<DH>(b, brows, 0));
#pragma unroll
  for (int kk = 1; kk < DH / 16; ++kk)
    wgmma_ss_n64(acc, desc_k<DH>(a, arows, kk), desc_k<DH>(b, brows, kk), 1);
  wgmma_commit();
}

// acc += A B with A's K / 16 fragments (16 deep) in registers and B K rows
// of a row-major tile read MN-major (not committed)
template <int DH, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[DH / 2],
                                         uint32_t (&a)[K / 16][4],
                                         uint32_t b, int brows) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc)
    wgmma_pv<DH>(acc, a[kc], desc_mn<DH>(b, brows, kc));
}

// a 64 x N accumulator as N / 16 bf16 A fragments (16 deep): its layout is
// the A-fragment layout, chunk kc being its n-tiles 2 kc and 2 kc + 1
template <int N>
__device__ __forceinline__ void pack(const float (&s)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    a[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    a[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    a[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    a[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// One CTA a (key tile of kDkdvKeys, KV head, batch, part of the split), in
// that order with the key tile slowest: under the causal mask the first
// key tiles see the most query rows, so the heaviest CTAs start first.  The
// CTA walks the (group head, visible query tile) pairs of its part, heads
// slowest; the pairs of a key tile are cut into `split` runs that differ by
// at most one pair.  Warpgroup 0 loads (K and V once, then Q, dO and their
// rows' lse2 and D a step through the ring); warpgroups 1 and 2 own 64 keys
// each and compute S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
// registers, and dV += P^T dO, dK += dS^T Q.  With split 1 the CTA writes
// dK (times scale) and dV in bf16; else float32 partials
// part[(split part, dK|dV), b, skv, KV, DH] that fa_bwd_reduce_bf16_kernel
// sums.  BwdPlan.dkdv_order (kernels/flash_attention.py) states this order
// for the tests.
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1)
fa_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse2,
                        const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        float* __restrict__ part, int nb, int sq, int skv,
                        int H, int KV, int sq_pad, int causal, int split,
                        float scale, float scale_log2) {
  using G = DkdvGeo<DH>;
  constexpr int kAcc = DH / 2;             // dK or dV floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + G::kKVBytes;
  const uint32_t sQ = sV + G::kKVBytes;                 // + st * kQBytes
  const uint32_t sO = sQ + kDkdvStages * G::kQBytes;    // dO
  const uint32_t sL = sO + kDkdvStages * G::kQBytes;    // + st * kRowBytes
  const uint32_t sD = sL + kDkdvStages * G::kRowBytes;
  const uint32_t bars = sD + kDkdvStages * G::kRowBytes;
  const float* gL = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* gD = reinterpret_cast<const float*>(smem_raw + (sD - raw));
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kDkdvStages + st); };

  const int per_tile = KV * nb * split;
  const int key0 = blockIdx.x / per_tile * kDkdvKeys;
  const int rest = blockIdx.x % per_tile;
  const int sp = rest % split, kvh = rest / split % KV;
  const int b = rest / (split * KV);
  const int qper = H / KV, off = skv - sq;
  const int n_qt = (sq + kDkdvRows - 1) / kDkdvRows;
  const int qt0 = causal ? max(0, key0 - off) / kDkdvRows : 0;
  const int n_vis = n_qt - qt0;            // query tiles that see a key
  const long long pairs = static_cast<long long>(qper) * n_vis;
  const int lo = static_cast<int>(pairs * sp / split);
  const int n_items = static_cast<int>(pairs * (sp + 1) / split) - lo;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kDkdvStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kBwdConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread loads K and V, then keeps the Q/dO ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_items > 0) {
      mbar_expect_tx(kv_full, 2 * G::kKVBytes);
      tma_tile<DH>(sK, &tk, kv_full, kvh, key0, b, kDkdvKeys);
      tma_tile<DH>(sV, &tv, kv_full, kvh, key0, b, kDkdvKeys);
      for (int n = 0; n < n_items; ++n) {
        const int st = n % kDkdvStages;
        if (n >= kDkdvStages)
          mbar_wait(empty(st), (n / kDkdvStages - 1) & 1);
        const int h = kvh * qper + (lo + n) / n_vis;
        const int q0 = (qt0 + (lo + n) % n_vis) * kDkdvRows;
        const long long r = (static_cast<long long>(b) * H + h) * sq_pad + q0;
        mbar_expect_tx(full(st), 2 * G::kQBytes + 2 * G::kRowBytes);
        tma_tile<DH>(sQ + st * G::kQBytes, &tq, full(st), h, q0, b,
                     kDkdvRows);
        tma_tile<DH>(sO + st * G::kQBytes, &tdo, full(st), h, q0, b,
                     kDkdvRows);
        bulk_load(sL + st * G::kRowBytes, lse2 + r, G::kRowBytes, full(st));
        bulk_load(sD + st * G::kRowBytes, dsum + r, G::kRowBytes, full(st));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup c: keys kr0 .. kr0 + 63; this lane's keys krow and
  // krow + 8, at the query columns 8 j + 2 tig + {0, 1} of a step
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t sKc = sK + 64 * c * G::kSw, sVc = sV + 64 * c * G::kSw;
  const int kr0 = key0 + 64 * c;
  const int krow = kr0 + warp * 16 + g;
  float adk[kAcc], adv[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) adk[j] = adv[j] = 0.0f;
  if (n_items > 0) mbar_wait(kv_full, 0);
  for (int n = 0; n < n_items; ++n) {
    const int st = n % kDkdvStages;
    const int q0 = (qt0 + (lo + n) % n_vis) * kDkdvRows;
    const uint32_t tQ = sQ + st * G::kQBytes, tO = sO + st * G::kQBytes;
    const float* L = gL + st * kDkdvRows + 2 * tig;
    const float* D = gD + st * kDkdvRows + 2 * tig;
    // K's and V's addresses anew each step: hoisted out of the loop, the
    // products' descriptors would hold 32 registers, and ptxas would
    // serialise the wgmma for want of them
    uint32_t aK = sKc, aV = sVc;
    asm volatile("" : "+r"(aK), "+r"(aV));
    mbar_wait(full(st), (n / kDkdvStages) & 1);
    float s[kDkdvRows / 2], dp[kDkdvRows / 2];
    issue_ss<DH>(s, aK, kDkdvKeys, tQ, kDkdvRows);    // S^T = K Q^T
    issue_ss<DH>(dp, aV, kDkdvKeys, tO, kDkdvRows);   // dP^T = V dO^T
    wgmma_wait_one();
    fence_regs(s);
    // P^T = exp2(S^T scale_log2 - lse2 of the column's query); the mask
    // only where the warpgroup's keys cross the step's diagonal: key
    // krow + 8 (e >> 1) is hidden from query q0 + 8 j + 2 tig + (e & 1)
    // where lead + 8 (e >> 1) - 8 j - (e & 1) > 0
    const bool masked = causal && kr0 + 63 > q0 + off;
    const int lead = krow - q0 - 2 * tig - off;
#pragma unroll
    for (int j = 0; j < kDkdvRows / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(L + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(
            __fmaf_rn(s[4 * j + e], scale_log2, (e & 1) ? -l.y : -l.x));
        s[4 * j + e] =
            masked && lead + 8 * (e >> 1) - 8 * j - (e & 1) > 0 ? 0.0f : p;
      }
    }
    wgmma_wait_all();
    fence_regs(dp);
    // dS^T = P^T (dP^T - D of the column's query)
#pragma unroll
    for (int j = 0; j < kDkdvRows / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(D + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] =
            s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
    }
    uint32_t pa[kDkdvRows / 16][4], da[kDkdvRows / 16][4];
    pack<kDkdvRows>(s, pa);
    pack<kDkdvRows>(dp, da);
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    issue_rs<DH, kDkdvRows>(adv, pa, tO, kDkdvRows);      // dV += P^T dO
    issue_rs<DH, kDkdvRows>(adk, da, tQ, kDkdvRows);      // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(da);
    if (lane == 0) mbar_arrive(empty(st));
  }

  // epilogue: rows krow and krow + 8 (keys past skv are not written)
  const long long n_elem = static_cast<long long>(nb) * skv * KV * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = krow + 8 * half;
    if (key >= skv) continue;
    const long long at =
        (static_cast<long long>(b) * skv + key) * KV * DH + kvh * DH;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const int d0 = 8 * j + 2 * tig;
      const float k0 = adk[4 * j + 2 * half], k1 = adk[4 * j + 2 * half + 1];
      const float v0 = adv[4 * j + 2 * half], v1 = adv[4 * j + 2 * half + 1];
      if (split == 1) {
        *reinterpret_cast<uint32_t*>(dk + at + d0) =
            pack_bf16(k0 * scale, k1 * scale);
        *reinterpret_cast<uint32_t*>(dv + at + d0) = pack_bf16(v0, v1);
      } else {
        float* pk = part + 2 * sp * n_elem + at + d0;
        *reinterpret_cast<float2*>(pk) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(pk + n_elem) = make_float2(v0, v1);
      }
    }
  }
}

// dK and dV of split > 1: the parts summed in their order, dK times scale,
// cast to bf16; four elements a thread a step
__global__ void __launch_bounds__(256)
fa_bwd_reduce_bf16_kernel(const float* __restrict__ part,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, long long n_elem,
                          int split, float scale) {
  const long long step = static_cast<long long>(gridDim.x) * 256 * 4;
  const long long first =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  for (long long i = first; i < n_elem; i += step) {
    float4 k = *reinterpret_cast<const float4*>(part + i);
    float4 v = *reinterpret_cast<const float4*>(part + n_elem + i);
    for (int s = 1; s < split; ++s) {
      const float4 pk =
          *reinterpret_cast<const float4*>(part + 2 * s * n_elem + i);
      const float4 pv =
          *reinterpret_cast<const float4*>(part + (2 * s + 1) * n_elem + i);
      k.x += pk.x; k.y += pk.y; k.z += pk.z; k.w += pk.w;
      v.x += pv.x; v.y += pv.y; v.z += pv.z; v.w += pv.w;
    }
    *reinterpret_cast<uint2*>(dk + i) =
        make_uint2(pack_bf16(k.x * scale, k.y * scale),
                   pack_bf16(k.z * scale, k.w * scale));
    *reinterpret_cast<uint2*>(dv + i) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// One CTA a (query tile of kDqRows, head, batch), heads fastest (a group's
// heads share K and V in L2) and, under the causal mask, the last query
// tiles (which see the most keys) first.  Warpgroup 0 loads Q and dO once,
// then K and V a tile through the ring; warpgroups 1 and 2 own 64 rows each
// and compute S = Q K^T, dP = dO V^T, P and dS in registers, and
// dQ += dS K; dQ times scale is written in bf16.  BwdPlan.dq_order states
// this order for the tests.
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1)
fa_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse2,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dq, int nb, int sq,
                      int skv, int H, int KV, int sq_pad, int causal,
                      float scale, float scale_log2) {
  using G = DqGeo<DH>;
  constexpr int kAcc = DH / 2;             // dQ floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + G::kQBytes;                  // dO
  const uint32_t sK = sO + G::kQBytes;                  // + st * kKVBytes
  const uint32_t sV = sK + kDqStages * G::kKVBytes;
  const uint32_t bars = sV + kDqStages * G::kKVBytes;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kDqStages + st); };

  const int n_qt = (sq + kDqRows - 1) / kDqRows;
  const int per_tile = H * nb;
  const int qt = causal ? n_qt - 1 - blockIdx.x / per_tile
                        : blockIdx.x / per_tile;
  const int h = blockIdx.x % H, b = blockIdx.x / H % nb;
  const int kvh = h / (H / KV), off = skv - sq;
  const int q0 = qt * kDqRows;
  int kend = skv;                          // keys any row of the CTA sees
  if (causal) kend = min(skv, q0 + kDqRows + off);
  const int n_tiles = kend > 0 ? (kend + kDqKeys - 1) / kDqKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kBwdConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * G::kQBytes);
      tma_tile<DH>(sQ, &tq, q_full, h, q0, b, kDqRows);
      tma_tile<DH>(sO, &tdo, q_full, h, q0, b, kDqRows);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kDqStages;
        if (t >= kDqStages) mbar_wait(empty(st), (t / kDqStages - 1) & 1);
        mbar_expect_tx(full(st), 2 * G::kKVBytes);
        tma_tile<DH>(sK + st * G::kKVBytes, &tk, full(st), kvh,
                     t * kDqKeys, b, kDqKeys);
        tma_tile<DH>(sV + st * G::kKVBytes, &tv, full(st), kvh,
                     t * kDqKeys, b, kDqKeys);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup c: rows r0 .. r0 + 63; this lane's rows row0 and
  // row0 + 8, at the key columns 8 j + 2 tig + {0, 1} of a tile
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t sQc = sQ + 64 * c * G::kSw, sOc = sO + 64 * c * G::kSw;
  const int r0 = q0 + 64 * c;
  const int row0 = r0 + warp * 16 + g;
  const long long rb = (static_cast<long long>(b) * H + h) * sq_pad;
  const float l0 = lse2[rb + row0], l1 = lse2[rb + row0 + 8];
  const float d0 = dsum[rb + row0], d1 = dsum[rb + row0 + 8];
  float adq[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) adq[j] = 0.0f;
  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kDqStages;
    const int key0 = t * kDqKeys;
    const uint32_t tK = sK + st * G::kKVBytes, tV = sV + st * G::kKVBytes;
    mbar_wait(full(st), (t / kDqStages) & 1);
    float s[kDqKeys / 2], dp[kDqKeys / 2];
    issue_ss<DH>(s, sQc, kDqRows, tK, kDqKeys);       // S = Q K^T
    issue_ss<DH>(dp, sOc, kDqRows, tV, kDqKeys);      // dP = dO V^T
    wgmma_wait_one();
    fence_regs(s);
    // P = exp2(S scale_log2 - lse2 of the row); the mask only where the
    // tile crosses skv (its rows are TMA's zeros) or the diagonal
    const bool masked =
        key0 + kDqKeys > skv || (causal && key0 + kDqKeys - 1 > r0 + off);
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(
            __fmaf_rn(s[4 * j + e], scale_log2, (e >> 1) ? -l1 : -l0));
        const int key = key0 + 8 * j + 2 * tig + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        s[4 * j + e] =
            masked && (key >= skv || (causal && key > row + off)) ? 0.0f : p;
      }
    }
    wgmma_wait_all();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kDqKeys / 2; ++j)
      dp[j] = s[j] * (dp[j] - ((j & 2) ? d1 : d0));
    uint32_t da[kDqKeys / 16][4];
    pack<kDqKeys>(dp, da);
    fence_regs(adq);
    fence_regs(da);
    wgmma_fence();
    issue_rs<DH, kDqKeys>(adq, da, tK, kDqKeys);          // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adq);
    fence_regs(da);
    if (lane == 0) mbar_arrive(empty(st));
  }

  __nv_bfloat16* qb = dq + (static_cast<long long>(b) * sq * H + h) * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
      *reinterpret_cast<uint32_t*>(qb + static_cast<long long>(row) * H * DH +
                                   8 * j + 2 * tig) =
          pack_bf16(adq[4 * j + 2 * half] * scale,
                    adq[4 * j + 2 * half + 1] * scale);
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The bf16 backward: the prep pass, the dK/dV kernel (and the reduction
// of its parts when split > 1), the dQ kernel.  work holds lse2 and D
// (b, H, sq_pad) and, when split > 1, the parts (split, 2, b, skv, KV, DH),
// all float32.
template <int DH>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const __nv_bfloat16* o,
                const float* lse, const __nv_bfloat16* dout,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                float* work, int b, int sq, int skv, int H, int KV,
                int causal, int split, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const float scale_log2 = kLog2e * scale;
  const int sq_pad = (sq + kRowPad - 1) / kRowPad * kRowPad;
  const long long rows = static_cast<long long>(b) * H * sq_pad;
  float* lse2 = work;
  float* dsum = work + rows;
  float* part = dsum + rows;
  fa_bwd_prep_bf16_kernel<DH><<<static_cast<unsigned>((rows + 7) / 8), 256,
                                0, stream>>>(o, dout, lse, lse2, dsum, rows,
                                             sq, H, sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout lq{static_cast<long long>(sq) * H * DH,
                  static_cast<long long>(H) * DH, DH};
  const Layout lk{static_cast<long long>(skv) * KV * DH,
                  static_cast<long long>(KV) * DH, DH};
  CUtensorMap tq, tdo, tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (skv > 0) {
    if (!make_map<DH>(&tq, q, b, sq, H, lq, kDkdvRows) ||
        !make_map<DH>(&tdo, dout, b, sq, H, lq, kDkdvRows) ||
        !make_map<DH>(&tk, k, b, skv, KV, lk, kDkdvKeys) ||
        !make_map<DH>(&tv, v, b, skv, KV, lk, kDkdvKeys))
      return static_cast<int>(cudaErrorInvalidValue);
    int e = set_smem(fa_bwd_dkdv_bf16_kernel<DH>, DkdvGeo<DH>::kSmem);
    if (e != 0) return e;
    const long long ctas = static_cast<long long>(
        (skv + kDkdvKeys - 1) / kDkdvKeys) * KV * b * split;
    fa_bwd_dkdv_bf16_kernel<DH>
        <<<static_cast<unsigned>(ctas), kBwdThreads, DkdvGeo<DH>::kSmem,
           stream>>>(tq, tk, tv, tdo, lse2, dsum, dk, dv, part, b, sq, skv,
                     H, KV, sq_pad, causal, split, scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (split > 1) {
      const long long n_elem = static_cast<long long>(b) * skv * KV * DH;
      const long long blocks = (n_elem / 4 + 255) / 256;
      fa_bwd_reduce_bf16_kernel<<<static_cast<unsigned>(
                                      blocks < 4096 ? blocks : 4096),
                                  256, 0, stream>>>(part, dk, dv, n_elem,
                                                    split, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  memset(&tq, 0, sizeof(tq));
  memset(&tdo, 0, sizeof(tdo));
  if (!make_map<DH>(&tq, q, b, sq, H, lq, kDqRows) ||
      !make_map<DH>(&tdo, dout, b, sq, H, lq, kDqRows) ||
      (skv > 0 && (!make_map<DH>(&tk, k, b, skv, KV, lk, kDqKeys) ||
                   !make_map<DH>(&tv, v, b, skv, KV, lk, kDqKeys))))
    return static_cast<int>(cudaErrorInvalidValue);
  int e = set_smem(fa_bwd_dq_bf16_kernel<DH>, DqGeo<DH>::kSmem);
  if (e != 0) return e;
  const long long ctas =
      static_cast<long long>((sq + kDqRows - 1) / kDqRows) * H * b;
  fa_bwd_dq_bf16_kernel<DH><<<static_cast<unsigned>(ctas), kBwdThreads,
                              DqGeo<DH>::kSmem, stream>>>(
      tq, tk, tv, tdo, lse2, dsum, dq, b, sq, skv, H, KV, sq_pad, causal,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FA_BWD_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* lse, const void* dout,     \
                      void* dq, void* dk, void* dv, void* dsum, int b,      \
                      int sq, int skv, int H, int KV, int dh, int causal,   \
                      void* stream) {                                       \
    return launch_dh<T>(q, k, v, o, lse, dout, dq, dk, dv, dsum, b, sq,     \
                        skv, H, KV, dh, causal, stream);                    \
  }

FA_BWD_ENTRY(flash_attention_bwd_f32, float)

// work: float32, 2 b H sq_pad floats (lse2, D) and, when split > 1,
// 2 split b skv KV dh more (the dK/dV parts); sq_pad = sq rounded up to 128
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* work, int b, int sq, int skv, int H, int KV, int dh, int causal,
    int split, void* stream) {
  if (b <= 0 || sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  using B = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launch) {
    return launch(static_cast<const B*>(q), static_cast<const B*>(k),
                  static_cast<const B*>(v), static_cast<const B*>(o),
                  static_cast<const float*>(lse), static_cast<const B*>(dout),
                  static_cast<B*>(dq), static_cast<B*>(dk), static_cast<B*>(dv),
                  static_cast<float*>(work), b, sq, skv, H, KV, causal, split,
                  s);
  };
  switch (dh) {
    case 32: return go(launch_bf16<32>);
    case 64: return go(launch_bf16<64>);
    case 128: return go(launch_bf16<128>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
