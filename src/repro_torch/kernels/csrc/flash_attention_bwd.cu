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
//   * float32 (flash_attention_bwd_f32: the vlm's cross-attention and
//     whisper's encoder and cross-attention, which their float32 memory
//     promotes, and the reduced models' card-vs-host checks): the SIMT
//     kernels of the first half.  TF32 tensor cores would keep ~3 digits,
//     short of the 1e-4 those checks hold, so the bound is FFMA's 67
//     TFLOP/s.
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
// bf16 kernels recompute S and do v^T for dQ: 14 dh flops a pair, so at
// best 71 % of the bound.  float32 runs at FFMA's 67 TFLOP/s: at the vlm's
// cross-attention (b 4, 1024 queries x 1600 image embeddings, H 32, KV 8,
// dh 128) 268.4 GFLOP, 4.006 ms; its kernel computes S and dP once.
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
// Design, float32, after FlashAttention-2's backward, register-tiled SIMT
// as PR 22's float32 forward (csrc/flash_attention.cu, fa_f32_kernel):
//   * The bf16 path's plan and dK/dV grid: a prep pass (lse2 = lse log2e
//     and D, rows padded to 128 with lse2 = +inf), a dK/dV kernel of one
//     CTA a (key tile of 128, KV head, batch, part of the split), heaviest
//     first, walking its part of the (group head, query tile of 64) pairs;
//     the parts' float32 partials summed in a fixed order.  bwd_plan
//     splits wider for this kernel (one CTA an SM, long runs): 4 CTAs an
//     SM when the grid is short, and enough parts that the last wave is
//     nearly full.
//   * dQ is not a second kernel: each dK/dV step also computes its rows'
//     dS K over the tile's keys and writes it as a float32 partial (key
//     tile, b, h, dh, rows), and a reduction sums a row's partials in key
//     tile order.  S and dP are computed once (10 dh flops a pair, the
//     bound's count, against 14 with a dQ kernel that recomputes them);
//     the partials cost key tiles x b x H x dh x sq_pad floats of scratch,
//     written once and read once.
//   * 256 threads as 16 x 16.  A thread owns 8 keys of the CTA: S^T and
//     dP^T at 8 x kJ, dK and dV at 8 x dh/16, and a 4 x 4 (2 x 4 at dh 32)
//     block of the step's dQ partial.  K^T and V^T are staged once,
//     transposed ([d][128]); Q and dO (with their rows' lse2 and D) stream
//     through a three-slot cp.async ring as one stream Q_0, dO_0, Q_1, ...,
//     each load started a compute phase before it is read, three barriers
//     a step.  A step is 64 query rows at dh <= 64 and 32 at dh 128, where
//     shared memory holds no more (220 KB).
//   * Per 4 columns of d, S^T reads 8 float4 of K^T (two addresses a warp)
//     and kJ float4 of Q for 32 kJ FMAs; an output product, per row, 2
//     float4 of P (or dS) and dh/64 float4 of dO (or Q) for 8 dh/16 FMAs;
//     the dQ partial, per 4 keys, 4 float4 of K^T and 4 of dS for 64.  P
//     and dS are stored [query row][key] as two float4 a row, the layout
//     the products read.
//   * Every product an explicit __fmaf_rn (the library is built with
//     --fmad=false), the softmax in the log2 domain with one fma; the mask
//     only on steps that cross the diagonal; a padding row's lse2 = +inf
//     makes its P 0 without a mask, and a key past skv touches only its
//     own dK and dV rows, which are not written, and adds 0 to dQ (its K
//     row is zeros).
#include <string.h>
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: register-tiled SIMT (FlashAttention-2's backward)
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;       // 16 x 16
constexpr int kF32Keys = 128;          // keys of a CTA
constexpr int kF32Rows = 64;           // query rows of a plan's pair
constexpr int kF32Slots = 3;           // ring slots
constexpr int kF32Micro = 8;           // keys of a thread
constexpr int kF32SmallStep = 64;      // query rows of a step at dh <= 64,
constexpr int kF32BigStep = 32;        // and at dh 128
constexpr int kF32RowPad = 128;        // lse2 / D / dQ partial rows padded to
constexpr int kF32DqRows = 32;         // query rows of a dQ reduction block

// Shared memory of the float32 kernel, in floats.  A [d][128] tile (K^T,
// V^T) and a [step][128] one (P, dS) have rows of kT; a [step][d] tile of
// the ring (Q, dO) rows of kS: both 4 mod 32, so that a warp's reads of 8
// neighbouring rows are conflict-free.
template <int DH>
struct F32Bwd {
  static constexpr int kStep = DH > 64 ? kF32BigStep : kF32SmallStep;
  static constexpr int kJ = kStep / 16;            // S columns a thread
  static constexpr int kS = DH + 4;
  static constexpr int kT = kF32Keys + 4;
  static constexpr int kOC = DH / 16;              // output columns a thread
  static constexpr int kVW = kOC < 4 ? kOC : 4;    // read / written at once
  static constexpr int kGroups = kOC / kVW;
  // the dQ partial of a step: thread (cy, qx) = (tid / kQG, tid % kQG)
  // owns columns cy + kCG i and rows qx + kQG j; per 4 keys kDqC float4 of
  // K^T (a few addresses a warp) and kDqR float4 of dS feed 4 kDqC kDqR
  // FMAs
  static constexpr int kCG = DH >= 128 ? 32 : 16;
  static constexpr int kQG = kF32Threads / kCG;
  static constexpr int kDqC = DH / kCG;
  static constexpr int kDqR = kStep / kQG;
  // K^T and V^T, the ring of Q and dO tiles (each slot followed by its
  // rows' lse2 or D), P and dS
  static constexpr int kSlot = kStep * kS + kStep;
  static constexpr int kSmem =
      4 * (2 * DH * kT + kF32Slots * kSlot + 2 * kStep * kT);
  static_assert(kF32Keys == kF32Micro * 16, "a thread's 8 keys, 16 deep");
  static_assert(kDqC * kCG == DH && kDqR * kQG == kStep &&
                    kF32Rows % kF32DqRows == 0,
                "the dQ partial's tiles");
  static_assert(kF32Rows % kStep == 0 && kF32RowPad % kStep == 0 &&
                    (kStep * DH / 4) % kF32Threads == 0,
                "float32 backward steps");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// W (2 or 4) consecutive floats of shared memory in one load
template <int W>
__device__ __forceinline__ void lds(float* dst, const float* src) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

// 128 rows r0 .. r0 + 127 of one head of a contiguous (b, s, heads, DH)
// tensor (src at its batch and head, rows `rs` floats apart) into a [DH][kT]
// tile, transposed; rows past n as zeros.  Consecutive threads take
// consecutive rows, so the transposing stores are conflict-free.
template <int DH>
__device__ __forceinline__ void stage_t(float* dst, const float* src,
                                        long long rs, int r0, int n) {
  constexpr int TS = F32Bwd<DH>::kT;
#pragma unroll 4
  for (int i = 0; i < kF32Keys * DH / 4 / kF32Threads; ++i) {
    const int e = threadIdx.x + i * kF32Threads;
    const int r = e % kF32Keys, c4 = e / kF32Keys;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n)
      x = __ldg(reinterpret_cast<const float4*>(src + (r0 + r) * rs +
                                                c4 * 4));
    dst[(c4 * 4 + 0) * TS + r] = x.x;
    dst[(c4 * 4 + 1) * TS + r] = x.y;
    dst[(c4 * 4 + 2) * TS + r] = x.z;
    dst[(c4 * 4 + 3) * TS + r] = x.w;
  }
}

// rows r0 .. r0 + kStep - 1 of one head (src at its batch and head, rows
// `rs` floats apart) into a [kStep][kS] ring slot by cp.async; rows past n
// as zeros
template <int DH>
__device__ __forceinline__ void fetch_rows(float* slot, const float* src,
                                           long long rs, int r0, int n) {
  using G = F32Bwd<DH>;
#pragma unroll
  for (int i = 0; i < G::kStep * DH / 4 / kF32Threads; ++i) {
    const int e = threadIdx.x + i * kF32Threads;
    const int r = e / (DH / 4), c4 = e % (DH / 4);
    const bool in = r0 + r < n;
    cp_async16(smem_u32(slot + r * G::kS + c4 * 4),
               src + (in ? (r0 + r) * rs : 0) + c4 * 4, in);
  }
}

// acc[i][j] = sum_k a[kCG i][k] b[kQG j][k] over the 128 keys of a
// [.][kT] tile a (K^T at the thread's first column) and one b (dS at its
// first row): the thread's block of a step's dQ partial
template <int DH>
__device__ __forceinline__ void dq_part(
    float (&acc)[F32Bwd<DH>::kDqC][F32Bwd<DH>::kDqR], const float* a,
    const float* b) {
  using G = F32Bwd<DH>;
  constexpr int C = G::kDqC, R = G::kDqR;
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kF32Keys; k += 4) {
    float av[C][4], bv[R][4];
#pragma unroll
    for (int i = 0; i < C; ++i) lds<4>(av[i], a + i * G::kCG * G::kT + k);
#pragma unroll
    for (int j = 0; j < R; ++j) lds<4>(bv[j], b + j * G::kQG * G::kT + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < C; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[i][j] = __fmaf_rn(av[i][kk], bv[j][kk], acc[i][j]);
  }
}

// acc[i][j] = sum_d at[d][8 ty + i] b[tx + 16 j][d]: at a [DH][kT] tile
// (K^T or V^T), b a [kStep][kS] one of the ring (Q or dO); per 4 columns of
// d, 8 float4 of at (two rows a warp: broadcasts) and kJ float4 of b feed
// 32 kJ FMAs
template <int DH>
__device__ __forceinline__ void dot_t(float (&acc)[kF32Micro][F32Bwd<DH>::kJ],
                                      const float* at, const float* b) {
  using G = F32Bwd<DH>;
  constexpr int J = G::kJ;
#pragma unroll
  for (int i = 0; i < kF32Micro; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float bv[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j) lds<4>(bv[j], b + j * 16 * G::kS + d);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float av[kF32Micro];
      lds<4>(av, at + (d + dd) * G::kT);
      lds<4>(av + 4, at + (d + dd) * G::kT + 4);
#pragma unroll
      for (int i = 0; i < kF32Micro; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j][dd], acc[i][j]);
    }
  }
}

// acc[i][c] += sum_r a[r][8 ty + i] b[r][col(c)] over the kStep rows of a
// [kStep][kT] tile a (P or dS) and a [kStep][kS] tile b, col(c) =
// 16 VW g + VW tx + e for c = VW g + e; per row 2 float4 of a
// (broadcasts) and kOC / VW vectors of b feed 8 kOC FMAs
template <int DH>
__device__ __forceinline__ void acc_rows(
    float (&acc)[kF32Micro][F32Bwd<DH>::kOC], const float* a,
    const float* b) {
  using G = F32Bwd<DH>;
  constexpr int OC = G::kOC, VW = G::kVW;
#pragma unroll 8
  for (int r = 0; r < G::kStep; ++r) {
    float av[kF32Micro], bv[OC];
    lds<4>(av, a + r * G::kT);
    lds<4>(av + 4, a + r * G::kT + 4);
#pragma unroll
    for (int g = 0; g < G::kGroups; ++g)
      lds<VW>(bv + g * VW, b + r * G::kS + g * 16 * VW);
#pragma unroll
    for (int i = 0; i < kF32Micro; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c)
        acc[i][c] = __fmaf_rn(av[i], bv[c], acc[i][c]);
  }
}

// the thread's 8 x kJ block of a [kStep][kT] tile transposed: element (i, j)
// at row tx + 16 j, column 8 ty + i, as two float4 a row
template <int DH>
__device__ __forceinline__ void store_t(float* dst,
                                        const float (&v)[kF32Micro]
                                                        [F32Bwd<DH>::kJ]) {
  using G = F32Bwd<DH>;
#pragma unroll
  for (int j = 0; j < G::kJ; ++j) {
    float* row = dst + j * 16 * G::kT;
    *reinterpret_cast<float4*>(row) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(v[4][j], v[5][j], v[6][j], v[7][j]);
  }
}

// rows 8 ty + i (< n) of a contiguous (.., n, heads, DH) output (dst at
// its batch, head and first row, rows `rs` apart): acc * mul
template <int DH>
__device__ __forceinline__ void store_out(
    float* dst, long long rs, int n, int tx, int ty,
    const float (&acc)[kF32Micro][F32Bwd<DH>::kOC], float mul) {
  using G = F32Bwd<DH>;
  constexpr int VW = G::kVW;
#pragma unroll
  for (int i = 0; i < kF32Micro; ++i) {
    const int row = kF32Micro * ty + i;
    if (row >= n) continue;
#pragma unroll
    for (int g = 0; g < G::kGroups; ++g) {
      float* p = dst + row * rs + g * 16 * VW + tx * VW;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(p) = make_float4(
            acc[i][g * 4] * mul, acc[i][g * 4 + 1] * mul,
            acc[i][g * 4 + 2] * mul, acc[i][g * 4 + 3] * mul);
      else
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[i][g * 2] * mul, acc[i][g * 2 + 1] * mul);
    }
  }
}

// lse2[b, h, i] = lse * log2e and D[b, h, i] = sum_d do o over rows padded
// to kF32RowPad (b, H, sq_pad), a warp a row; a padding row gets lse2 =
// +inf and D = 0, so that its P, and so its dS, is 0
template <int DH>
__global__ void __launch_bounds__(256)
fa_bwd_prep_f32_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ lse2,
                       float* __restrict__ dsum, long long rows, int sq,
                       int H, int sq_pad) {
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
  // each lane DH / 32 consecutive elements of the row
  constexpr int kE = DH / 32;
  const long long at = (((bh / H) * sq + i) * H + bh % H) * DH + lane * kE;
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e) acc = __fmaf_rn(dout[at + e], o[at + e], acc);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    lse2[w] = lse[bh * sq + i] * kLog2e;
    dsum[w] = acc;
  }
}

// One CTA a (key tile of 128, KV head, batch, part of the split), the key
// tile slowest, as the bf16 kernel and BwdPlan.dkdv_order: the CTA keeps
// K^T and V^T of its keys and walks its part's (group head, query tile of
// 64) pairs in steps of kStep rows.  A step's Q and dO tiles (each with
// its rows' lse2 or D) come through a three-slot cp.async ring as one
// stream Q_0, dO_0, Q_1, ...: Q_{s+1} is started a step ahead, dO_s while
// S^T of step s runs.  Thread (ty, tx) owns keys 8 ty + i of the tile: S^T
// and dP^T at the step's rows tx + 16 j, and dK, dV at the columns of
// store_out.  With split 1 the CTA writes dK (times scale) and dV; else
// float32 partials part[(split part, dK|dV), b, skv, KV, DH] that
// fa_bwd_reduce_f32_kernel sums.  Each step also writes its rows' dQ over
// the tile's keys, dS K, as a float32 partial dqp[key tile, b, h, DH,
// sq_pad] (rows fastest) that fa_bwd_dq_reduce_f32_kernel sums over the
// key tiles: dQ needs no second kernel that recomputes S and dP.
template <int DH>
__global__ void __launch_bounds__(kF32Threads, 1)
fa_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse2,
                       const float* __restrict__ dsum, float* __restrict__ dk,
                       float* __restrict__ dv, float* __restrict__ part,
                       float* __restrict__ dqp, int nb, int sq, int skv,
                       int H, int KV, int sq_pad, int causal, int split,
                       float scale, float scale_log2) {
  using G = F32Bwd<DH>;
  constexpr int ST = G::kStep, J = G::kJ, OC = G::kOC;
  constexpr int kSub = kF32Rows / ST;      // steps of a pair
  extern __shared__ float4 smem_f4[];
  float* kT = reinterpret_cast<float*>(smem_f4);
  float* vT = kT + DH * G::kT;
  float* ring = vT + DH * G::kT;
  float* sP = ring + kF32Slots * G::kSlot;    // P: query rows, keys
  float* sDS = sP + ST * G::kT;                   // dS

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int per_tile = KV * nb * split;
  const int key0 = blockIdx.x / per_tile * kF32Keys;
  const int rest = blockIdx.x % per_tile;
  const int sp = rest % split, kvh = rest / split % KV;
  const int b = rest / (split * KV);
  const int qper = H / KV, off = skv - sq;
  const int n_qt = (sq + kF32Rows - 1) / kF32Rows;
  const int qt0 = causal ? max(0, key0 - off) / kF32Rows : 0;
  const int n_vis = n_qt - qt0;            // query tiles that see a key
  const long long pairs = static_cast<long long>(qper) * n_vis;
  const int lo = static_cast<int>(pairs * sp / split);
  const int n_steps =
      (static_cast<int>(pairs * (sp + 1) / split) - lo) * kSub;
  const long long qrs = static_cast<long long>(H) * DH;
  const long long krs = static_cast<long long>(KV) * DH;
  const long long kbase = static_cast<long long>(b) * skv * krs + kvh * DH;
  const long long plane = static_cast<long long>(DH) * sq_pad;
  const int cy = threadIdx.x / G::kQG, qx = threadIdx.x % G::kQG;
  float* dqp_kt = dqp + (static_cast<long long>(blockIdx.x / per_tile) * nb
                         + b) * H * plane + cy * sq_pad + qx;

  // step s's head and first row
  auto step_at = [&](int s, int& h, int& q0) {
    const int item = lo + s / kSub;
    h = kvh * qper + item / n_vis;
    q0 = (qt0 + item % n_vis) * kF32Rows + (s % kSub) * ST;
  };
  // load n of the stream into slot n % kF32Slots: Q_{n/2} and its rows'
  // lse2 (n even) or dO_{n/2} and D (n odd); one commit group a load
  auto fetch = [&](int n) {
    if (n < 2 * n_steps) {
      int h, q0;
      step_at(n >> 1, h, q0);
      float* slot = ring + (n % kF32Slots) * G::kSlot;
      fetch_rows<DH>(slot, ((n & 1) ? dout : q) +
                               static_cast<long long>(b) * sq * qrs + h * DH,
                     qrs, q0, sq);
      if (threadIdx.x < ST / 4)          // rows padded: always in range
        cp_async16(smem_u32(slot + ST * G::kS + 4 * threadIdx.x),
                   ((n & 1) ? dsum : lse2) +
                       (static_cast<long long>(b) * H + h) * sq_pad + q0 +
                       4 * threadIdx.x,
                   true);
    }
    cp_async_commit();
  };
  fetch(0);
  stage_t<DH>(kT, k + kbase, krs, key0, skv);
  stage_t<DH>(vT, v + kbase, krs, key0, skv);

  float adk[kF32Micro][OC], adv[kF32Micro][OC];
#pragma unroll
  for (int i = 0; i < kF32Micro; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) adk[i][c] = adv[i][c] = 0.0f;
  const float* kTt = kT + kF32Micro * ty;
  const float* vTt = vT + kF32Micro * ty;
  const int mykey = key0 + kF32Micro * ty;

  for (int s = 0; s < n_steps; ++s) {
    // Q_s has landed, and every thread is done with step s - 1 (the slots
    // of dO_{s-1} and Q_{s-1}, P and dS), which the next loads refill
    cp_async_wait<0>();
    __syncthreads();
    fetch(2 * s + 1);                     // dO_s
    fetch(2 * s + 2);                     // Q_{s+1}
    int h, q0;
    step_at(s, h, q0);
    const float* tQ = ring + ((2 * s) % kF32Slots) * G::kSlot;
    const float* tO = ring + ((2 * s + 1) % kF32Slots) * G::kSlot;
    float st[kF32Micro][J], dp[kF32Micro][J];
    dot_t<DH>(st, kTt, tQ + tx * G::kS);            // S^T = K Q^T
    cp_async_wait<1>();                   // dO_s has landed
    __syncthreads();
    dot_t<DH>(dp, vTt, tO + tx * G::kS);            // dP^T = V dO^T
    // P = exp2(S scale_log2 - lse2), 0 where hidden (the mask only where
    // the tile's keys cross the step's diagonal; rows past sq have lse2 =
    // +inf); dS = P (dP - D)
    const bool masked = causal && key0 + kF32Keys - 1 > q0 + off;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = tx + 16 * j;
      const float l2 = tQ[ST * G::kS + r], d = tO[ST * G::kS + r];
#pragma unroll
      for (int i = 0; i < kF32Micro; ++i) {
        float p = exp2f(__fmaf_rn(st[i][j], scale_log2, -l2));
        if (masked && mykey + i > q0 + r + off) p = 0.0f;
        st[i][j] = p;
        dp[i][j] = p * (dp[i][j] - d);
      }
    }
    store_t<DH>(sP + tx * G::kT + kF32Micro * ty, st);
    store_t<DH>(sDS + tx * G::kT + kF32Micro * ty, dp);
    __syncthreads();
    acc_rows<DH>(adv, sP + kF32Micro * ty, tO + G::kVW * tx);  // dV += P^T dO
    acc_rows<DH>(adk, sDS + kF32Micro * ty, tQ + G::kVW * tx); // dK += dS^T Q
    float pq[G::kDqC][G::kDqR];                                // dS K
    dq_part<DH>(pq, kT + cy * G::kT, sDS + qx * G::kT);
    float* dst = dqp_kt + h * plane + q0;
#pragma unroll
    for (int i = 0; i < G::kDqC; ++i)
#pragma unroll
      for (int j = 0; j < G::kDqR; ++j)
        dst[i * G::kCG * sq_pad + j * G::kQG] = pq[i][j];
  }
  cp_async_wait<0>();                     // nothing left in flight
  if (split == 1) {
    store_out<DH>(dk + kbase + static_cast<long long>(key0) * krs, krs,
                  skv - key0, tx, ty, adk, scale);
    store_out<DH>(dv + kbase + static_cast<long long>(key0) * krs, krs,
                  skv - key0, tx, ty, adv, 1.0f);
  } else {
    const long long n_elem = static_cast<long long>(nb) * skv * KV * DH;
    float* pk = part + 2 * sp * n_elem + kbase +
                static_cast<long long>(key0) * krs;
    store_out<DH>(pk, krs, skv - key0, tx, ty, adk, 1.0f);
    store_out<DH>(pk + n_elem, krs, skv - key0, tx, ty, adv, 1.0f);
  }
}

// dK and dV of split > 1: the parts summed in their order, dK times scale;
// four elements a thread a step
__global__ void __launch_bounds__(256)
fa_bwd_reduce_f32_kernel(const float* __restrict__ part,
                         float* __restrict__ dk, float* __restrict__ dv,
                         long long n_elem, int split, float scale) {
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
    *reinterpret_cast<float4*>(dk + i) =
        make_float4(k.x * scale, k.y * scale, k.z * scale, k.w * scale);
    *reinterpret_cast<float4*>(dv + i) = v;
  }
}

// dq[b, i, h, :] = scale * the sum of dqp[kt, b, h, :, i] over the key
// tiles kt that see row i's query tile of 64 (the ones whose dK/dV steps
// wrote it), in kt order: a block a (32 rows, head, batch), read along the
// rows and written along the columns through shared memory
template <int DH>
__global__ void __launch_bounds__(256)
fa_bwd_dq_reduce_f32_kernel(const float* __restrict__ dqp,
                            float* __restrict__ dq, int nb, int sq, int skv,
                            int H, int sq_pad, int causal, float scale) {
  __shared__ float tile[DH][kF32DqRows + 1];
  const int q0 = blockIdx.x * kF32DqRows, h = blockIdx.y, b = blockIdx.z;
  const int n_kt = (skv + kF32Keys - 1) / kF32Keys, off = skv - sq;
  int kts = n_kt;                  // as fa_bwd_dkdv_f32_kernel's qt0
  if (causal) {
    kts = 0;
    while (kts < n_kt &&
           max(0, kts * kF32Keys - off) / kF32Rows <= q0 / kF32Rows)
      ++kts;
  }
  const long long plane = static_cast<long long>(DH) * sq_pad;
  const long long kt_stride = static_cast<long long>(nb) * H * plane;
  const float* src =
      dqp + (static_cast<long long>(b) * H + h) * plane + q0;
  const int lane = threadIdx.x % kF32DqRows;
  for (int c = threadIdx.x / kF32DqRows; c < DH;
       c += 256 / kF32DqRows) {
    float acc = 0.0f;
    for (int kt = 0; kt < kts; ++kt)
      acc += src[kt * kt_stride + static_cast<long long>(c) * sq_pad + lane];
    tile[c][lane] = acc * scale;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kF32DqRows * DH; e += 256) {
    const int r = e / DH, c = e % DH;
    if (q0 + r < sq)
      dq[((static_cast<long long>(b) * sq + q0 + r) * H + h) * DH + c] =
          tile[c][r];
  }
}

template <int DH>
int launch_f32(const float* q, const float* k, const float* v,
               const float* o, const float* lse, const float* dout, float* dq,
               float* dk, float* dv, float* work, int b, int sq, int skv,
               int H, int KV, int causal, int split, cudaStream_t stream) {
  using G = F32Bwd<DH>;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const float scale_log2 = kLog2e * scale;
  const int sq_pad = (sq + kF32RowPad - 1) / kF32RowPad * kF32RowPad;
  const long long rows = static_cast<long long>(b) * H * sq_pad;
  const long long n_elem = static_cast<long long>(b) * skv * KV * DH;
  float* lse2 = work;
  float* dsum = work + rows;
  float* part = dsum + rows;
  float* dqp = part + (split > 1 ? 2 * split * n_elem : 0);
  fa_bwd_prep_f32_kernel<DH><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                               stream>>>(o, dout, lse, lse2, dsum, rows, sq,
                                         H, sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (skv > 0) {
    err = cudaFuncSetAttribute(fa_bwd_dkdv_f32_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long ctas = static_cast<long long>(
        (skv + kF32Keys - 1) / kF32Keys) * KV * b * split;
    fa_bwd_dkdv_f32_kernel<DH>
        <<<static_cast<unsigned>(ctas), kF32Threads, G::kSmem, stream>>>(
            q, k, v, dout, lse2, dsum, dk, dv, part, dqp, b, sq, skv, H, KV,
            sq_pad, causal, split, scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (split > 1) {
      const long long blocks = (n_elem / 4 + 255) / 256;
      fa_bwd_reduce_f32_kernel<<<static_cast<unsigned>(
                                     blocks < 4096 ? blocks : 4096),
                                 256, 0, stream>>>(part, dk, dv, n_elem,
                                                   split, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const dim3 grid((sq + kF32DqRows - 1) / kF32DqRows, H, b);
  fa_bwd_dq_reduce_f32_kernel<DH><<<grid, 256, 0, stream>>>(
      dqp, dq, b, sq, skv, H, sq_pad, causal, scale);
  return static_cast<int>(cudaGetLastError());
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

// work (both dtypes): float32, 2 b H sq_pad floats (lse2, D) and, when
// split > 1, 2 split b skv KV dh more (the dK/dV parts); sq_pad = sq
// rounded up to 128
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* work, int b, int sq, int skv, int H, int KV, int dh, int causal,
    int split, void* stream) {
  if (b <= 0 || sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launch) {
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(o),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(dout), static_cast<float*>(dq),
                  static_cast<float*>(dk), static_cast<float*>(dv),
                  static_cast<float*>(work), b, sq, skv, H, KV, causal, split,
                  s);
  };
  switch (dh) {
    case 32: return go(launch_f32<32>);
    case 64: return go(launch_f32<64>);
    case 128: return go(launch_f32<128>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
