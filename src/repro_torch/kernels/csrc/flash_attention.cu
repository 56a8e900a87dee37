// Softmax attention forward, causal or bidirectional, with grouped KV heads:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * dh^-0.5) v[b, j, g]
// with g = h / (H / KV).  Causal masking is aligned to the bottom right:
// query i sees key j iff j <= i + (skv - sq), which is the usual mask when
// sq == skv and the cached-prefill mask when sq < skv.  q, k, v and o are in
// the model's (b, s, heads, dh) layout, read and written through their
// strides (dh contiguous), so no transpose is copied.  Any sq and skv: the
// ragged tails of the last query and key blocks are masked.
// Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_bhsd
// (_fa_kernel), the TPU kernel that carries the online-softmax state
// (acc, m, l) in VMEM across a sequential kv grid axis and skips blocks
// above the causal diagonal.
//
// Bound: operations at prefill lengths.  4*dh flops per visible (query,
// key) pair and head against q, k, v read once and o written once: at b=4,
// s=1024, H=32, KV=2, dh=128 (causal) it is 34.4 GFLOP and 71 MB in
// bfloat16, 35 us of bf16 tensor-core time against 21 us of memory time.
//
// Design, bfloat16 (the serving path): FlashAttention-2 on mma.sync.
//   * One CTA per (64-row query block, head, batch), four warps, each warp
//     owning 16 query rows.  A warp keeps its Q rows as m16n8k16 A
//     fragments in registers for the whole key loop.
//   * The CTA walks 64-key tiles: K is staged row-major and V transposed
//     into shared memory (rows padded by 8 elements, so the fragment loads
//     hit 32 distinct banks), zero-filled past skv.  Tiles above the
//     diagonal of the CTA's last row are never loaded.
//   * S = Q K^T in float32 accumulators; mask, scale by dh^-0.5 * log2(e)
//     and update the running row max m and sum l in float32 (a quad of
//     lanes shares a row: two xor-shuffles give the row max).  The S
//     accumulators' layout is the A-fragment layout of P, so P goes to the
//     P.V product as bfloat16 straight from registers.
//   * O is rescaled in registers and divided by l at the end (a row that
//     sees no key gives 0), then written as bfloat16 through o's strides.
// Design, float32 (checks and float32 models): a plain SIMT kernel, one warp
// per query row and one lane per key of a 32-key tile, float32 throughout
// (expf, no tensor cores), so it matches the exact softmax to float32
// rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Layout {           // strides in elements of (b, s, heads); dh is 1
  long long b, s, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16x8x16(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16, 64 query rows x 64-key tiles per step
// ---------------------------------------------------------------------------
constexpr int kBlockQ = kWarps * 16;
constexpr int kBlockK = 64;
constexpr int kPad = 8;

template <int DH>
__global__ void __launch_bounds__(kThreads)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int sq, int skv, int qper,
               Layout lq, Layout lk, Layout lv, Layout lo, int causal,
               float scale_log2) {
  constexpr int kChunksD = DH / 16;       // k-steps of S = Q K^T
  constexpr int kTilesKey = kBlockK / 8;  // n-tiles of S
  constexpr int kChunksKey = kBlockK / 16;// k-steps of O = P V
  constexpr int kTilesD = DH / 8;         // n-tiles of O
  constexpr int kVecRow = DH / 8;         // 16-byte vectors in one K row

  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 vts[DH][kBlockK + kPad];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / qper;
  const int off = skv - sq;
  const int row0 = q0 + warp * 16 + g;    // this lane's two query rows
  const int row1 = row0 + 8;

  const __nv_bfloat16* qb = q + b * lq.b + h * lq.h;
  const __nv_bfloat16* kb = k + b * lk.b + kvh * lk.h;
  const __nv_bfloat16* vb = v + b * lv.b + kvh * lv.h;

  // Q rows of this warp as A fragments (rows past sq are zero)
  uint32_t qa[kChunksD][4];
#pragma unroll
  for (int c = 0; c < kChunksD; ++c) {
    const int d0 = c * 16 + tig * 2;
    qa[c][0] = row0 < sq ? *reinterpret_cast<const uint32_t*>(
                               qb + row0 * lq.s + d0) : 0u;
    qa[c][1] = row1 < sq ? *reinterpret_cast<const uint32_t*>(
                               qb + row1 * lq.s + d0) : 0u;
    qa[c][2] = row0 < sq ? *reinterpret_cast<const uint32_t*>(
                               qb + row0 * lq.s + d0 + 8) : 0u;
    qa[c][3] = row1 < sq ? *reinterpret_cast<const uint32_t*>(
                               qb + row1 * lq.s + d0 + 8) : 0u;
  }

  float acc[kTilesD][4];
#pragma unroll
  for (int t = 0; t < kTilesD; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  // keys any row of this CTA can see
  int kend = skv;
  if (causal) kend = min(skv, q0 + kBlockQ + off);
  const int n_tiles = kend > 0 ? (kend + kBlockK - 1) / kBlockK : 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kBlockK;
    __syncthreads();                       // the previous tile is consumed
    // K row-major: neighbouring threads read neighbouring 16-byte vectors
    for (int e = tid; e < kBlockK * kVecRow; e += kThreads) {
      const int j = e / kVecRow, c = e % kVecRow;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key0 + j < skv)
        val = *reinterpret_cast<const uint4*>(kb + (key0 + j) * lk.s + c * 8);
      *reinterpret_cast<uint4*>(&ks[j][c * 8]) = val;
    }
    // V transposed: neighbouring threads take neighbouring keys, so the
    // 2-byte shared stores of one warp land in distinct banks
    for (int e = tid; e < kBlockK * kVecRow; e += kThreads) {
      const int j = e % kBlockK, c = e / kBlockK;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key0 + j < skv)
        val = *reinterpret_cast<const uint4*>(vb + (key0 + j) * lv.s + c * 8);
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vts[c * 8 + i][j] = pv[i];
    }
    __syncthreads();

    float s[kTilesKey][4];
#pragma unroll
    for (int t = 0; t < kTilesKey; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunksD; ++c) {
#pragma unroll
      for (int t = 0; t < kTilesKey; ++t) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            &ks[t * 8 + g][c * 16 + tig * 2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &ks[t * 8 + g][c * 16 + 8 + tig * 2]);
        mma_bf16_16x8x16(s[t], qa[c], b0, b1);
      }
    }

    // mask, scale into the log2 domain, row max over the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < kTilesKey; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + t * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool keep = col < skv && (!causal || col <= row + off);
        s[t][e] = keep ? s[t][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key yet keeps m = -inf; subtract 0 instead
    const float use0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float use1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float corr0 = exp2f(m0 - use0), corr1 = exp2f(m1 - use1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int t = 0; t < kTilesKey; ++t) {
      s[t][0] = exp2f(s[t][0] - use0);
      s[t][1] = exp2f(s[t][1] - use0);
      s[t][2] = exp2f(s[t][2] - use1);
      s[t][3] = exp2f(s[t][3] - use1);
      ps0 += s[t][0] + s[t][1];
      ps1 += s[t][2] + s[t][3];
    }
    l0 = l0 * corr0 + ps0;                 // this lane's share of the row
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int t = 0; t < kTilesD; ++t) {
      acc[t][0] *= corr0;
      acc[t][1] *= corr0;
      acc[t][2] *= corr1;
      acc[t][3] *= corr1;
    }

    // O += P V: S tiles 2c and 2c+1 are the A fragment of key chunk c
#pragma unroll
    for (int c = 0; c < kChunksKey; ++c) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      pa[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      pa[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int t = 0; t < kTilesD; ++t) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            &vts[t * 8 + g][c * 16 + tig * 2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &vts[t * 8 + g][c * 16 + 8 + tig * 2]);
        mma_bf16_16x8x16(acc[t], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  __nv_bfloat16* ob = o + b * lo.b + h * lo.h;
#pragma unroll
  for (int t = 0; t < kTilesD; ++t) {
    const int d0 = t * 8 + tig * 2;
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * lo.s + d0) =
          pack_bf16(acc[t][0] * inv0, acc[t][1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * lo.s + d0) =
          pack_bf16(acc[t][2] * inv1, acc[t][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: SIMT, one warp per query row, one lane per key of a 32-key tile
// ---------------------------------------------------------------------------
constexpr int kTileSimt = 32;

template <int DH>
__global__ void __launch_bounds__(kThreads)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq,
              int skv, int qper, Layout lq, Layout lk, Layout lv, Layout lo,
              int causal, float scale) {
  constexpr int kPerLane = DH / 32;        // output dims of one lane
  __shared__ float qs[kWarps][DH];
  __shared__ float ks[kTileSimt][DH + 1];  // +1: lane j reads row j
  __shared__ float vs[kTileSimt][DH];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / qper;
  const int off = skv - sq;
  const int q0 = blockIdx.x * kWarps;
  const int row = q0 + warp;
  const bool live = row < sq;

  const float* kb = k + b * lk.b + kvh * lk.h;
  const float* vb = v + b * lv.b + kvh * lv.h;
  for (int d = lane; d < DH; d += 32)
    qs[warp][d] = live ? q[b * lq.b + row * lq.s + h * lq.h + d] : 0.0f;

  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  int kend = skv;
  if (causal) kend = min(skv, q0 + kWarps + off);
  const int n_tiles = kend > 0 ? (kend + kTileSimt - 1) / kTileSimt : 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kTileSimt;
    __syncthreads();
    for (int e = tid; e < kTileSimt * DH; e += kThreads) {
      const int j = e / DH, d = e % DH;
      const bool in = key0 + j < skv;
      ks[j][d] = in ? kb[(key0 + j) * lk.s + d] : 0.0f;
      vs[j][d] = in ? vb[(key0 + j) * lv.s + d] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;                   // whole warps skip together
    const int key = key0 + lane;
    float dot = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) dot += qs[warp][d] * ks[lane][d];
    const bool keep = key < skv && (!causal || key <= row + off);
    const float sc = keep ? dot * scale : -INFINITY;
    float mt = sc;
    for (int sh = 16; sh > 0; sh >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, sh));
    const float mn = fmaxf(m, mt);
    const float use = mn == -INFINITY ? 0.0f : mn;
    const float corr = expf(m - use);
    const float p = expf(sc - use);
    float ps = p;
    for (int sh = 16; sh > 0; sh >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, sh);
    m = mn;
    l = l * corr + ps;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= corr;
    for (int j = 0; j < kTileSimt; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[i] += pj * vs[j][lane + 32 * i];
    }
  }
  if (!live) return;
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  float* ob = o + b * lo.b + row * lo.s + h * lo.h;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) ob[lane + 32 * i] = acc[i] * inv;
}

}  // namespace

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int sq,
    int skv, int H, int KV, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, void* stream) {
  if (b <= 0 || sq <= 0 || H <= 0) return 0;
  const Layout lq{qsb, qss, qsh}, lk{ksb, kss, ksh}, lv{vsb, vss, vsh},
      lo{osb, oss, osh};
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, H, b);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(dh));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  const int qper = H / KV;
  switch (dh) {
    case 32:
      fa_bf16_kernel<32><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
          qper, lq, lk, lv, lo, causal, scale_log2);
      break;
    case 64:
      fa_bf16_kernel<64><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
          qper, lq, lk, lv, lo, causal, scale_log2);
      break;
    case 128:
      fa_bf16_kernel<128><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
          qper, lq, lk, lv, lo, causal, scale_log2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int b, int sq,
    int skv, int H, int KV, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, void* stream) {
  if (b <= 0 || sq <= 0 || H <= 0) return 0;
  const Layout lq{qsb, qss, qsh}, lk{ksb, kss, ksh}, lv{vsb, vss, vsh},
      lo{osb, oss, osh};
  const dim3 grid((sq + kWarps - 1) / kWarps, H, b);
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  const int qper = H / KV;
  switch (dh) {
    case 32:
      fa_f32_kernel<32><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
          qper, lq, lk, lv, lo, causal, scale);
      break;
    case 64:
      fa_f32_kernel<64><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
          qper, lq, lk, lv, lo, causal, scale);
      break;
    case 128:
      fa_f32_kernel<128><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
          qper, lq, lk, lv, lo, causal, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
