// Softmax attention forward, causal or bidirectional, with grouped KV heads:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * dh^-0.5) v[b, j, g]
// with g = h / (H / KV).  Causal masking is aligned to the bottom right:
// query i sees key j iff j <= i + (skv - sq), which is the usual mask when
// sq == skv and the cached-prefill mask when sq < skv.  q, k, v and o are in
// the model's (b, s, heads, dh) layout, read and written through their
// strides (dh contiguous), so no transpose is copied.  Any sq and skv.
// Hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:68, flash_attention_bhsd,
// and its Pallas kernel _fa_kernel (:25), which carries the online-softmax
// state (acc, m, l) in VMEM across a sequential kv grid axis and skips the
// blocks above the causal diagonal.
//
// Bound: operations at prefill lengths.  4*dh flops per visible (query,
// key) pair and head, against q, k, v read once and o written once: at
// glm4-9b's prefill (b=4, s=1000, H=32, KV=2, dh=128, causal) 32.8 GFLOP
// and 69.6 MB, 33 us of bf16 tensor-core time at 989 TFLOP/s against 21 us
// of memory time.  Only wgmma reaches that rate.  Each pair also takes one
// exp on the special-function units (16 a clock per SM), about half the
// products' time, so the exps have to run beside the products.
//
// Design, bfloat16 (the serving path), after FlashAttention-3:
//   * Warp specialisation: a CTA of three warpgroups.  Warpgroup 0 is the
//     producer; it hands its registers over (setmaxnreg 24) and one thread
//     issues every load.  Warpgroups 1 and 2 consume (setmaxnreg 240), each
//     owning 64 query rows of a 128-row work item.
//   * Loads by TMA.  Each of q, k, v is a 4-D tensor map (dh, heads, s, b)
//     encoded on the host from its strides (cuTensorMapEncodeTiled, fetched
//     through cudaGetDriverEntryPoint); a box is 64 dh-columns (32 at
//     dh = 32) by 128 rows, with the 128-byte (64-byte) swizzle that wgmma
//     reads.  Rows past s arrive as zeros, so ragged tails need only the
//     mask.  Q comes once an item; K and V of 128-key tiles through a
//     two-stage ring with full and empty mbarriers for K and V apart, so a
//     stage's next K is loaded as soon as S no longer reads its last one.
//   * S = Q K^T: wgmma m64n128k16 with both operands K-major in shared
//     memory.  O += P V: P from registers (S's float32 accumulator layout is
//     the A-fragment layout of P once packed to bf16), V read MN-major
//     (transposed) straight from its row-major tile.
//   * Within a warpgroup S_t = Q K_t^T is issued before O += P_{t-1} V_{t-1},
//     so that tile t's softmax runs while the tensor cores work on the
//     previous tile's product.  S's first k-step only writes S, so S is not
//     live while P V is in flight, and S, O and P fit without spilling.
//   * Softmax in float32 in the log2 domain: each scaled subtract is one
//     explicit fma (__fmaf_rn: the library is built with --fmad=false for
//     spike_hist), then ex2.approx; the row max and sum over the quad of
//     lanes that shares a row; the mask only on tiles that cross skv or the
//     warpgroup's diagonal.
//   * Persistent: one CTA an SM (its 165 KB of shared memory allow no
//     second) walks the work items in strides of the grid, causal items
//     heaviest first.  The next item's Q is loaded as soon as both
//     consumers' last S of the current one is done, so loads overlap the
//     epilogue.
//   * Epilogue: divide by l (a row that sees no key gives 0) and store bf16
//     pairs through o's strides.
//   * The two warpgroups take turns at the tensor cores (FA-3's ping-pong),
//     so that one's softmax runs while the other's products do.  The turns
//     are mbarriers, not named barriers: with bar.sync ptxas serialised the
//     wgmma for want of registers (C7512) and spilled.
// Design, float32 (checks and float32 models): a plain SIMT kernel, one warp
// per query row and one lane per key of a 32-key tile, float32 throughout
// (expf, no tensor cores), so it matches the exact softmax to float32
// rounding.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>
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

// D(64 x 128) = [D +] A(64 x 16) B(16 x 128): A and B in shared memory,
// both K-major (B given as its transpose, n rows of 16)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128) = A(64 x 16) B(16 x 128), the same operands, D only written
// (so that it need not be live before)
__device__ __forceinline__ void wgmma_ss_n128_set(float (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D(64 x 32) = [D +] A(64 x 16) B(16 x 32): A in registers, B in shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 64) = [D +] A(64 x 16) B(16 x 64): A in registers, B in shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 128) = [D +] A(64 x 16) B(16 x 128): A in registers, B in shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles, warp-specialised
// ---------------------------------------------------------------------------
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBlockQ = 64 * kConsumers;       // query rows of a CTA
constexpr int kBlockK = 128;                   // keys of a tile
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kThreadsWs = 128 * (kConsumers + 1);
constexpr long long kWaitLimit = 1LL << 32;    // cycles (~2 s) before a trap

// Shared-memory geometry of a (rows x DH) bfloat16 tile as TMA writes it
// and wgmma reads it: DH split into column blocks of kSw bytes (128, or 64
// at DH = 32), each block rows x kSw bytes, 16-byte chunks XOR-swizzled
// within every 8 rows (TMA's 128- or 64-byte swizzle).
template <int DH>
struct Geo {
  static constexpr int kSw = DH * 2 < 128 ? DH * 2 : 128;
  static constexpr int kCols = kSw / 2;                   // DH of a box
  static constexpr int kBlocks = DH / kCols;
  static constexpr int kMode = kSw == 128 ? 1 : 2;        // descriptor
  static constexpr int kQBytes = kBlockQ * DH * 2;
  static constexpr int kKVBytes = kBlockK * DH * 2;
  // Q, the K ring, the V ring, then the barriers; +1 KB to align to 1 KB
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (4 + 4 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

// k-step kk (16 columns of DH) of a K-major tile whose column blocks are
// `rows` rows apart
template <int DH>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  constexpr int kSw = Geo<DH>::kSw;
  const uint32_t off = (kk * 32 / kSw) * rows * kSw + (kk * 32) % kSw;
  return gmma_desc(tile + off, 16, 8 * kSw, Geo<DH>::kMode);
}

// key chunk c (16 rows) of a row-major tile read MN-major (V as P.V's B):
// LBO steps between column blocks, SBO between 8-row groups
template <int DH>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int c) {
  constexpr int kSw = Geo<DH>::kSw;
  return gmma_desc(tile + c * 16 * kSw, rows * kSw, 8 * kSw,
                   Geo<DH>::kMode);
}

// keep the compiler from moving accumulator accesses across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until all but the last committed wgmma group have completed, or all
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 32) wgmma_rs_n32(d, a, db, 1);
  else if constexpr (DH == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed; a wait that
// outlasts kWaitLimit cycles (a lost arrival) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > kWaitLimit) __trap();
  } while (!done);
}

// one box (kCols of DH x rows) of a (dh, heads, s, b) tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(d0), "r"(head), "r"(row), "r"(batch) : "memory");
}

template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row0,
                                         int batch, int rows) {
#pragma unroll
  for (int cb = 0; cb < Geo<DH>::kBlocks; ++cb)
    tma_load(dst + cb * rows * Geo<DH>::kSw, map, bar, cb * Geo<DH>::kCols,
             head, row0, batch);
}

// S = Q K^T of one 64-row warpgroup against a 128-key tile, issued and
// committed, not waited for.  The first k-step only writes S, so S need not
// be live before: it is dead (packed into P) while P V is in flight.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t sQc,
                                         uint32_t tK) {
  wgmma_fence();
  wgmma_ss_n128_set(s, desc_k<DH>(sQc, kBlockQ, 0), desc_k<DH>(tK, kBlockK, 0));
#pragma unroll
  for (int kk = 1; kk < DH / 16; ++kk)
    wgmma_ss_n128(s, desc_k<DH>(sQc, kBlockQ, kk),
                  desc_k<DH>(tK, kBlockK, kk), 1);
  wgmma_commit();
}
// O += P V with P's A fragments in registers, issued and committed
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2],
                                         uint32_t (&pa)[8][4], uint32_t tV) {
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
    wgmma_pv<DH>(acc, pa[kc], desc_mn<DH>(tV, kBlockK, kc));
  wgmma_commit();
}
// Online softmax of one S tile in the log2 domain, in place: s becomes
// exp2(s * scale_log2 - m * scale_log2) with the rows' new max m; l takes
// the rows' new sums (this lane's share) and corr the factor that moves the
// old sums to the new max.  A lane holds rows row0 and row0 + 8: s[4j],
// s[4j+1] of row0 and s[4j+2], s[4j+3] of row0 + 8, at keys
// key0 + 8j + 2 tig + {0, 1}; the quad of lanes that shares a row reduces
// with two xor-shuffles.  The mask is applied only when `masked`.
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], bool masked, int key0, int skv, int causal, int row0,
    int off, int tig, float scale_log2, float& m0, float& m1, float& l0,
    float& l1, float& corr0, float& corr1) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + j * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row0 : row0 + 8;
        if (col >= skv || (causal && col > row + off))
          s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // a row with no visible key yet keeps m = -inf; subtract 0 instead
  const float use0 = mn0 == -INFINITY ? 0.0f : mn0 * scale_log2;
  const float use1 = mn1 == -INFINITY ? 0.0f : mn1 * scale_log2;
  corr0 = fast_exp2(__fmaf_rn(m0, scale_log2, -use0));
  corr1 = fast_exp2(__fmaf_rn(m1, scale_log2, -use1));
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[4 * j] = fast_exp2(__fmaf_rn(s[4 * j], scale_log2, -use0));
    s[4 * j + 1] = fast_exp2(__fmaf_rn(s[4 * j + 1], scale_log2, -use0));
    s[4 * j + 2] = fast_exp2(__fmaf_rn(s[4 * j + 2], scale_log2, -use1));
    s[4 * j + 3] = fast_exp2(__fmaf_rn(s[4 * j + 3], scale_log2, -use1));
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
}

// P as bfloat16 A fragments: S's accumulator layout is P's A-fragment
// layout, key chunk kc (16 keys) being S's n-tiles 2 kc and 2 kc + 1
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float corr0,
                                        float corr1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= corr0;
    acc[4 * j + 1] *= corr0;
    acc[4 * j + 2] *= corr1;
    acc[4 * j + 3] *= corr1;
  }
}

// Work item i of a launch: one 128-row query block of one (head, batch).
// Causal items come heaviest first (the last query blocks see the most
// keys), so that the CTAs that walk them in strides end close together.
struct Item {
  int h, b, q0, n_tiles;
};

__device__ __forceinline__ Item item_at(int i, int H, int nb, int sq,
                                        int skv, int causal) {
  const int n_qblocks = (sq + kBlockQ - 1) / kBlockQ;
  const int per_block = H * nb;
  const int qblock = causal ? n_qblocks - 1 - i / per_block : i / per_block;
  Item it;
  it.h = i % H;
  it.b = (i / H) % nb;
  it.q0 = qblock * kBlockQ;
  int kend = skv;                          // keys any row of the item sees
  if (causal) kend = min(skv, it.q0 + kBlockQ + skv - sq);
  it.n_tiles = kend > 0 ? (kend + kBlockK - 1) / kBlockK : 0;
  return it;
}

template <int DH>
__global__ void __launch_bounds__(kThreadsWs, 1)
fa_bf16_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int nb, int sq, int skv, int H,
               int qper, Layout lo, int causal, float scale_log2) {
  using G = Geo<DH>;
  constexpr int kO = DH / 2;              // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + G::kQBytes;               // + stage * kKVBytes
  const uint32_t sV = sK + kStages * G::kKVBytes;
  const uint32_t bars = sV + kStages * G::kKVBytes;
  // barriers: Q landed / released; K, V of a stage landed / released
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (2 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (2 + 3 * kStages + st); };
  // the consumer warpgroups' turns at the tensor cores, one barrier each
  auto turn = [&](int c) { return bars + 8 * (2 + 4 * kStages + c); };
  const int n_items = H * nb * ((sq + kBlockQ - 1) / kBlockQ);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);     // one arrival a consumer warp
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4 * kConsumers);
      mbar_init(v_empty(st), 4 * kConsumers);
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(turn(c), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread walks the CTA's items and keeps the ring full;
    // a stage's K is loaded once its last K is released, then its V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int n_q = 0, n_kv = 0;               // Q and K/V tiles loaded so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item it = item_at(i, H, nb, sq, skv, causal);
        if (it.n_tiles == 0) continue;
        if (n_q > 0) mbar_wait(q_empty, (n_q - 1) & 1);
        mbar_expect_tx(q_full, G::kQBytes);
        tma_tile<DH>(sQ, &tq, q_full, it.h, it.q0, it.b, kBlockQ);
        ++n_q;
        for (int t = 0; t < it.n_tiles; ++t, ++n_kv) {
          const int st = n_kv % kStages;
          const int parity = (n_kv / kStages - 1) & 1;
          const int kvh = it.h / qper;
          if (n_kv >= kStages) mbar_wait(k_empty(st), parity);
          mbar_expect_tx(k_full(st), G::kKVBytes);
          tma_tile<DH>(sK + st * G::kKVBytes, &tk, k_full(st), kvh,
                       t * kBlockK, it.b, kBlockK);
          if (n_kv >= kStages) mbar_wait(v_empty(st), parity);
          mbar_expect_tx(v_full(st), G::kKVBytes);
          tma_tile<DH>(sV + st * G::kKVBytes, &tv, v_full(st), kvh,
                       t * kBlockK, it.b, kBlockK);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup c: query rows r0 .. r0 + 63 of each item.  Every
  // arrival on an empty barrier follows the wait on its full barrier, so
  // that each phase of an empty barrier counts the arrivals of one load.
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t sQc = sQ + 64 * c * G::kSw;
  const int off = skv - sq;
  int n_q = 0, n_kv = 0;                   // Q and K/V tiles consumed so far
  // warpgroup c's k-th turn waits for the other's (k-1)-th pass (0 goes
  // first); both take n_tiles + 1 turns an item
  int n_turn = 0;
  auto take_turn = [&]() {
    mbar_wait(turn(c), (n_turn & 1) ^ (c == 0));
  };
  auto pass_turn = [&]() {
    if (lane == 0) mbar_arrive(turn(1 - c));
    ++n_turn;
  };
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item_at(i, H, nb, sq, skv, causal);
    const int r0 = it.q0 + 64 * c;
    const int row0 = r0 + warp * 16 + g;   // this lane's rows: row0, row0 + 8
    int kend = r0 < sq ? skv : 0;          // rows past sq need no key
    if (causal) kend = min(kend, r0 + 64 + off);
    // tiles this warpgroup sees: the item's first n_mine (all but its last
    // one at most)
    const int n_mine = kend > 0 ? (kend + kBlockK - 1) / kBlockK : 0;

    float acc[kO];
#pragma unroll
    for (int j = 0; j < kO; ++j) acc[j] = 0.0f;
    float s[64];
    uint32_t pa[8][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float corr0, corr1;

    if (it.n_tiles > 0) {
      mbar_wait(q_full, n_q & 1);
      ++n_q;
      if (n_mine == 0 && lane == 0) mbar_arrive(q_empty);
    }
    // a tile needs the mask where it crosses skv or the warpgroup's diagonal
    auto masked = [&](int key0) {
      return key0 + kBlockK > skv || (causal && key0 + kBlockK - 1 > r0 + off);
    };
    auto stage = [&](int t) { return (n_kv + t) % kStages; };
    auto par = [&](int t) { return ((n_kv + t) / kStages) & 1; };
    if (n_mine > 0) {
      mbar_wait(k_full(stage(0)), par(0));
      take_turn();
      issue_qk<DH>(s, sQc, sK + stage(0) * G::kKVBytes);
      pass_turn();
      wgmma_wait_all();
      fence_regs(s);
      if (lane == 0) {
        mbar_arrive(k_empty(stage(0)));
        if (n_mine == 1) mbar_arrive(q_empty);
      }
      softmax_tile(s, masked(0), 0, skv, causal, row0, off, tig,
                   scale_log2, m0, m1, l0, l1, corr0, corr1);
      pack_p(s, pa);
      for (int t = 1; t < n_mine; ++t) {
        const int sk = stage(t), sv = stage(t - 1);
        mbar_wait(k_full(sk), par(t));
        mbar_wait(v_full(sv), par(t - 1));
        take_turn();
        issue_qk<DH>(s, sQc, sK + sk * G::kKVBytes);
        issue_pv<DH>(acc, pa, sV + sv * G::kKVBytes);
        pass_turn();
        wgmma_wait_one();                    // S_t is in
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(k_empty(sk));
          if (t == n_mine - 1) mbar_arrive(q_empty);
        }
        softmax_tile(s, masked(t * kBlockK), t * kBlockK, skv, causal,
                     row0, off, tig, scale_log2, m0, m1, l0, l1, corr0,
                     corr1);
        wgmma_wait_all();                    // P_{t-1} V_{t-1} is in
        fence_regs(acc);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(v_empty(sv));
        rescale(acc, corr0, corr1);
        pack_p(s, pa);
      }
      const int sv = stage(n_mine - 1);
      mbar_wait(v_full(sv), par(n_mine - 1));
      take_turn();
      issue_pv<DH>(acc, pa, sV + sv * G::kKVBytes);
      pass_turn();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(v_empty(sv));
    }
    if (n_mine == 0 && it.n_tiles > 0) {   // the turn of the missing P V
      take_turn();
      pass_turn();
    }
    for (int t = n_mine; t < it.n_tiles; ++t) {
      mbar_wait(k_full(stage(t)), par(t));
      if (lane == 0) mbar_arrive(k_empty(stage(t)));
      mbar_wait(v_full(stage(t)), par(t));
      if (lane == 0) mbar_arrive(v_empty(stage(t)));
      take_turn();
      pass_turn();
    }
    n_kv += it.n_tiles;

    // epilogue: divide by l (a row that sees no key gives 0), store bf16
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    __nv_bfloat16* ob = o + it.b * lo.b + it.h * lo.h;
    const int row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int d0 = j * 8 + tig * 2;
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * lo.s + d0) =
            pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (row1 < sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * lo.s + d0) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
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

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (so
// the library needs no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (b, s, heads, DH) bfloat16 tensor with strides l as the 4-D tensor map
// (DH, heads, s, b), boxes of kCols x 1 x rows x 1; rows past s read as 0
template <int DH>
bool make_map(CUtensorMap* map, const void* base, int b, int s, int heads,
              const Layout& l, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(l.h) * 2,
                                 static_cast<cuuint64_t>(l.s) * 2,
                                 static_cast<cuuint64_t>(l.b) * 2};
  const cuuint32_t box[4] = {Geo<DH>::kCols, 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Geo<DH>::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_bf16(cudaStream_t stream, const void* q, const void* k,
                const void* v, __nv_bfloat16* o, int b, int sq, int skv,
                int H, int KV, Layout lq, Layout lk, Layout lv, Layout lo,
                int causal, float scale_log2) {
  CUtensorMap tq, tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (!make_map<DH>(&tq, q, b, sq, H, lq, kBlockQ) ||
      (skv > 0 && (!make_map<DH>(&tk, k, b, skv, KV, lk, kBlockK) ||
                   !make_map<DH>(&tv, v, b, skv, KV, lv, kBlockK))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Geo<DH>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  // persistent: one CTA an SM (its shared memory allows no second), each
  // walking the work items in strides of the grid
  const long long items =
      static_cast<long long>(H) * b * ((sq + kBlockQ - 1) / kBlockQ);
  const int grid = static_cast<int>(items < sms ? items : sms);
  fa_bf16_kernel<DH><<<grid, kThreadsWs, Geo<DH>::kSmem, stream>>>(
      tq, tk, tv, o, b, sq, skv, H, H / KV, lo, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
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
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(dh));
  auto s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<__nv_bfloat16*>(o);
  switch (dh) {
    case 32:
      return launch_bf16<32>(s, q, k, v, op, b, sq, skv, H, KV, lq, lk, lv,
                             lo, causal, scale_log2);
    case 64:
      return launch_bf16<64>(s, q, k, v, op, b, sq, skv, H, KV, lq, lk, lv,
                             lo, causal, scale_log2);
    case 128:
      return launch_bf16<128>(s, q, k, v, op, b, sq, skv, H, KV, lq, lk, lv,
                              lo, causal, scale_log2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
