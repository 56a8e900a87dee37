// Softmax attention backward, causal or bidirectional, with grouped KV heads:
// given q, k, v, the forward's output o and its rows' log-sum-exp lse, and
// the output's gradient do, computes
//   P   = exp(q k^T * scale - lse)            (0 where the mask hides a key)
//   dV  = sum over the group's heads of P^T do
//   dS  = P * (do v^T - D),  D = rowsum(do * o)
//   dQ  = dS k * scale,  dK = sum over the group's heads of dS^T q * scale
// with scale = dh^-0.5 and the forward's bottom-right causal alignment
// (query i sees key j iff j <= i + (skv - sq)).  q, o, do, dq are
// (b, sq, H, dh), k, v, dk, dv (b, skv, KV, dh), all contiguous; lse and
// the scratch D are float32 (b, H, sq).  float32 or bfloat16 in and out,
// float32 inside; dh 32, 64 or 128.  Hand-written for Hopper (sm_90a).
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
// the bf16 tensor cores' 989 TFLOP/s.  This first version runs on the
// float32 FMA pipes (67 TFLOP/s), so it cannot come near that bound.
//
// Design, after FlashAttention-2's backward, SIMT:
//   * Three launches.  A pre-pass computes D = rowsum(do * o) in float32, a
//     warp a row.  A dK/dV kernel takes one CTA per (key tile of 64, KV
//     head, batch) and keeps its K and V tile and its dK and dV sums
//     resident while it walks the qper query heads of its group and every
//     query tile of 64 rows that sees the key tile; a dQ kernel takes one
//     CTA per (query tile of 64, head, batch) and walks the key tiles its
//     rows see.  Each recomputes S and do v^T; nothing is reduced across
//     CTAs, so there are no atomics and two launches give the same bits.
//   * 256 threads as 16 x 16; a thread owns a 4 x 4 micro-tile of S and
//     do v^T (rows ty + 16 i, keys tx + 16 j) and 4 rows x dh/16 columns of
//     each output (columns tx * VW + 16 VW g + e).  Tiles sit in shared
//     memory as float32 with a row stride of 4 mod 32 words, so that the
//     float4 reads of 8 neighbouring rows are conflict-free; P^T and dS^T
//     (dK/dV) or dS (dQ) are staged there for the output products.  Every
//     product is an explicit __fmaf_rn (the library is built with
//     --fmad=false).
//   * The mask only on tiles that cross sq, skv or the diagonal; query
//     tiles above the diagonal are never visited.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
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
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of a row: 4 floats or 8 bfloat16 as floats
__device__ __forceinline__ void load16(float* dst, const float* src) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
}
__device__ __forceinline__ void load16(float* dst, const __nv_bfloat16* src) {
  const uint4 t = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(p);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// VW consecutive outputs of a row, from floats
template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}
template <int VW>
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 p[VW / 2];
#pragma unroll
  for (int i = 0; i < VW / 2; ++i)
    p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  if constexpr (VW == 4)
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(p);
  else
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(p);
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
FA_BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)
