// Softmax attention forward, causal or bidirectional, with grouped KV heads:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * dh^-0.5) v[b, j, g]
// with g = h / (H / KV).  Causal masking is aligned to the bottom right:
// query i sees key j iff j <= i + (skv - sq), which is the usual mask when
// sq == skv and the cached-prefill mask when sq < skv.  q, k, v and o are in
// the model's (b, s, heads, dh) layout, read and written through their
// strides (dh contiguous), so no transpose is copied.  Any sq and skv.
// Given a non-null lse, each kernel also writes every row's log-sum-exp of
// its scaled scores, in natural log, float32 (b, H, sq): what the backward
// (flash_attention_bwd.cu) rebuilds the softmax from.  Serving passes null.
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
// Design, float32 (the vlm's cross-attention and whisper's encoder, which
// their float32 memory promotes; checks), after FlashAttention-2 with the
// products register-tiled as in a SIMT SGEMM.  float32 throughout: TF32
// tensor cores keep ~3 digits, so the bound is FFMA's 67 TFLOP/s.
//   * A CTA owns 128 query rows of one head at dh 128 (256 threads, one
//     an SM), else 64 (128 threads, three an SM at dh <= 64; at dh 128
//     when 128-row blocks would leave SMs idle).
//     Q^T is staged once; K and V tiles of 64 keys come through a cp.async
//     ring as one stream (K_0, V_0, K_1, ...), each load started a compute
//     phase before it is read.
//   * Each thread owns an 8 x 4 micro-tile of S and 8 x DH/16 of O.  S's
//     loop reads, per 4 columns of DH, 4 float4 of K and 8 of Q^T for 128
//     FMAs (2.7 a float loaded); O += P V reads, per key, 2 float4 of P^T
//     and DH/16 floats of V for 8 DH/16 FMAs (4 a float at DH 128).  Every
//     product is an explicit __fmaf_rn (the library is built with
//     --fmad=false).
//   * The 16 threads sharing a row sit in one half-warp, so the row's max
//     and sum are xor-shuffles; a tile takes two __syncthreads, each
//     before the tile's K or V is read.
//   * Softmax in the log2 domain (one fma, exp2f), the mask only on tiles
//     that cross skv or the block's diagonal, tiles above it skipped; a
//     row's sum is kept per thread and reduced once at the end.
#include <string.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a row's log-sum-exp in natural log from its running max m (raw score
// units) and its sum l of exp2((s - m) * scale_log2); -inf for a row that
// sees no key
__device__ __forceinline__ float row_lse(float m, float l, float scale_log2) {
  return l > 0.0f ? __fmaf_rn(m, scale_log2, log2f(l)) * kLn2 : -INFINITY;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles, warp-specialised
// ---------------------------------------------------------------------------
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBlockQ = 64 * kConsumers;       // query rows of a CTA
constexpr int kBlockK = 128;                   // keys of a tile
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kThreadsWs = 128 * (kConsumers + 1);

// Shared-memory geometry of the forward's CTA on top of the tile's swizzle
// (hopper.cuh): Q, the K ring, the V ring, then the barriers
template <int DH>
struct Geo : Swz<DH> {
  static constexpr int kQBytes = kBlockQ * DH * 2;
  static constexpr int kKVBytes = kBlockK * DH * 2;
  // +1 KB to align to 1 KB
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (4 + 4 * kStages);
};

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
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int nb,
               int sq, int skv, int H, int qper, Layout lo, int causal,
               float scale_log2) {
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

    // epilogue: divide by l (a row that sees no key gives 0), store bf16;
    // with lse, a row's log-sum-exp (b, H, sq) from the quad's first lane
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    __nv_bfloat16* ob = o + it.b * lo.b + it.h * lo.h;
    const int row1 = row0 + 8;
    if (lse != nullptr && tig == 0) {
      float* lb = lse + (static_cast<long long>(it.b) * H + it.h) * sq;
      if (row0 < sq) lb[row0] = row_lse(m0, l0, scale_log2);
      if (row1 < sq) lb[row1] = row_lse(m1, l1, scale_log2);
    }
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
// float32: register-tiled SIMT (FlashAttention-2 with SGEMM-style products)
// ---------------------------------------------------------------------------
constexpr int kF32Rows = 128;        // query rows of a CTA at dh 128 (256
constexpr int kF32RowsSmall = 64;    // threads), else 64 (128 threads)
constexpr int kF32SmallBelow = 1;    // dh 128 takes 64 rows if b H
                                     // ceil(sq / 128) < this x SMs
constexpr int kF32Keys = 64;         // keys of a K or V tile
constexpr int kF32Stages = 2;        // ring slots, each a K or a V tile
constexpr int kF32MicroRows = 8;     // S and O rows of a thread
constexpr int kF32Lanes = 16;        // threads sharing those rows

// Shared memory of a CTA, in floats: Q^T (DH x kQS), the ring of K and V
// tiles (kF32Keys x kKS each), P^T (kF32Keys x kQS).  Both strides are 4
// mod 32, so that the fragment reads below are conflict-free.
template <int DH, int BM>
struct F32Geo {
  static constexpr int kThreads = BM / kF32MicroRows * kF32Lanes;
  static constexpr int kQS = BM + 4;
  static constexpr int kKS = DH + 4;
  static constexpr int kSlot = kF32Keys * kKS;
  static constexpr int kSmem =
      4 * (DH * kQS + kF32Stages * kSlot + kF32Keys * kQS);
  // CTAs an SM asked of __launch_bounds__, which caps the registers: at
  // dh 128 one (64 O floats a thread; shared memory allows no second), at
  // dh <= 64 three of 128 threads (168 registers, 70 KB each)
  static constexpr int kMinBlocks = DH > 64 ? 1 : 3;
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

// A CTA owns BM query rows of one (head, batch) and walks the K and V
// tiles.  Thread (rg, cg) = (tid / 16, tid % 16) owns rows rg * 8 + i of
// the block: S at keys cg + 16 j of a tile, O at columns g * 16 VW + cg VW
// + e.  The 16 threads of a row group share a half-warp, so a row's max
// and sum are xor-shuffles.
template <int DH, int BM>
__global__ void __launch_bounds__(F32Geo<DH, BM>::kThreads,
                                  F32Geo<DH, BM>::kMinBlocks)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int skv, int qper, Layout lq,
              Layout lk, Layout lv, Layout lo, int causal, float scale_log2) {
  using G = F32Geo<DH, BM>;
  constexpr int RM = kF32MicroRows, BN = kF32Keys, NL = kF32Lanes;
  constexpr int KPT = BN / NL;             // S keys of a thread
  constexpr int OC = DH / NL;              // O columns of a thread,
  constexpr int VW = OC < 4 ? OC : 4;      // read VW at a time
  constexpr int QS = G::kQS, KS = G::kKS, T = G::kThreads;
  static_assert(RM % 4 == 0 && BN % NL == 0 && (BN * DH / 4) % T == 0 &&
                (BM * DH / 4) % T == 0, "float32 flash tile sizes");
  extern __shared__ float4 smem_f4[];
  float* qt = reinterpret_cast<float*>(smem_f4);
  float* ring = qt + DH * QS;
  float* pt = ring + kF32Stages * G::kSlot;

  const int tid = threadIdx.x;
  const int rg = tid / NL, cg = tid % NL;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / qper;
  const int q0 = blockIdx.x * BM;
  const int off = skv - sq;
  int kend = skv;                          // keys any row of the block sees
  if (causal) kend = min(skv, q0 + BM + off);
  const int n_tiles = kend > 0 ? (kend + BN - 1) / BN : 0;
  const float* kb = k + b * lk.b + kvh * lk.h;
  const float* vb = v + b * lv.b + kvh * lv.h;

  // load n of the stream K_0, V_0, K_1, V_1, ... into slot n % kF32Stages,
  // rows past skv as zeros; one commit group a load (empty past the end)
  auto fetch = [&](int n) {
    if (n < 2 * n_tiles) {
      const float* base = (n & 1) ? vb : kb;
      const long long rs = (n & 1) ? lv.s : lk.s;
      const int key0 = (n >> 1) * BN;
      const uint32_t slot = smem_u32(ring + (n % kF32Stages) * G::kSlot);
#pragma unroll
      for (int i = 0; i < BN * DH / 4 / T; ++i) {
        const int e = tid + i * T;
        const int r = e / (DH / 4), c4 = e % (DH / 4);
        const bool in = key0 + r < skv;
        cp_async16(slot + 4 * (r * KS + c4 * 4),
                   base + (in ? (key0 + r) * rs : 0) + c4 * 4, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kF32Stages - 1; ++n) fetch(n);

  // Q^T, once: consecutive threads take consecutive rows, so the
  // transposing stores are conflict-free; rows past sq as zeros
  const float* qb = q + b * lq.b + h * lq.h;
#pragma unroll 4
  for (int i = 0; i < BM * DH / 4 / T; ++i) {
    const int e = tid + i * T;
    const int r = e % BM, c4 = e / BM;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < sq)
      x = __ldg(reinterpret_cast<const float4*>(qb + (q0 + r) * lq.s +
                                                c4 * 4));
    qt[(c4 * 4 + 0) * QS + r] = x.x;
    qt[(c4 * 4 + 1) * QS + r] = x.y;
    qt[(c4 * 4 + 2) * QS + r] = x.z;
    qt[(c4 * 4 + 3) * QS + r] = x.w;
  }

  float acc[RM][OC];
  float m[RM], l[RM];                      // l: this thread's share
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }
  const float* qf = qt + rg * RM;
  const float* pf = pt + rg * RM;

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * BN;
    // K_t has landed, and every thread is done with the slot of load
    // 2t - 1, which the next load refills
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    fetch(2 * t + kF32Stages - 1);
    const float* kt = ring + ((2 * t) % kF32Stages) * G::kSlot + cg * KS;

    // S = Q K^T: per 4 columns of DH, KPT float4 of K and 2 RM float4 of
    // Q^T (broadcasts within the half-warp) feed 4 RM KPT FMAs
    float s[RM][KPT];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float kf[KPT][4];
#pragma unroll
      for (int j = 0; j < KPT; ++j) lds<4>(kf[j], kt + j * NL * KS + d);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float qv[RM];
#pragma unroll
        for (int r4 = 0; r4 < RM; r4 += 4)
          lds<4>(qv + r4, qf + (d + dd) * QS + r4);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < KPT; ++j)
            s[i][j] = __fmaf_rn(qv[i], kf[j][dd], s[i][j]);
      }
    }

    // the mask only where the tile crosses skv or the block's diagonal
    if (key0 + BN > skv || (causal && key0 + BN - 1 > q0 + off)) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int key = key0 + cg + j * NL, row = q0 + rg * RM + i;
          if (key >= skv || (causal && key > row + off)) s[i][j] = -INFINITY;
        }
    }

    // online softmax in the log2 domain; P^T to shared memory
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int sh = NL / 2; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float mn = fmaxf(m[i], mx);
      // a row with no visible key yet keeps m = -inf; subtract 0 instead
      const float use = mn == -INFINITY ? 0.0f : mn * scale_log2;
      const float corr = exp2f(__fmaf_rn(m[i], scale_log2, -use));
      m[i] = mn;
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = exp2f(__fmaf_rn(s[i][j], scale_log2, -use));
        ls += s[i][j];
      }
      l[i] = __fmaf_rn(l[i], corr, ls);
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
#pragma unroll
      for (int r4 = 0; r4 < RM; r4 += 4)
        *reinterpret_cast<float4*>(pt + (cg + j * NL) * QS + rg * RM + r4) =
            make_float4(s[r4][j], s[r4 + 1][j], s[r4 + 2][j], s[r4 + 3][j]);

    // V_t has landed (and P is visible), and every thread is done with
    // K_t's slot
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    fetch(2 * t + kF32Stages);
    const float* vt =
        ring + ((2 * t + 1) % kF32Stages) * G::kSlot + cg * VW;

    // O += P V: per key, 2 RM / 4 float4 of P^T (broadcasts) and OC / VW
    // vectors of V feed RM OC FMAs
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float pv[RM], vv[OC];
#pragma unroll
      for (int r4 = 0; r4 < RM; r4 += 4) lds<4>(pv + r4, pf + kk * QS + r4);
#pragma unroll
      for (int g = 0; g < OC / VW; ++g)
        lds<VW>(vv + g * VW, vt + kk * KS + g * NL * VW);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c)
          acc[i][c] = __fmaf_rn(pv[i], vv[c], acc[i][c]);
    }
  }

  // epilogue: the row sums over the half-warp, divide (a row that sees no
  // key gives 0), store VW floats at a time; with lse, a row's log-sum-exp
  // (b, H, sq) from the half-warp's first thread
  float* ob = o + b * lo.b + h * lo.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int sh = NL / 2; sh > 0; sh >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], sh);
    const int row = q0 + rg * RM + i;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
    if (row >= sq) continue;
    if (lse != nullptr && cg == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * sq + row] =
          row_lse(m[i], l[i], scale_log2);
#pragma unroll
    for (int g = 0; g < OC / VW; ++g) {
      float* dst = ob + row * lo.s + g * NL * VW + cg * VW;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
                        acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
      else
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[i][g * 2] * inv, acc[i][g * 2 + 1] * inv);
    }
  }
}

template <int DH>
int launch_bf16(cudaStream_t stream, const void* q, const void* k,
                const void* v, __nv_bfloat16* o, float* lse, int b, int sq,
                int skv,
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
      tq, tk, tv, o, lse, b, sq, skv, H, H / KV, lo, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int BM>
int launch_f32(cudaStream_t stream, const float* q, const float* k,
               const float* v, float* o, float* lse, int b, int sq, int skv,
               int H, int qper, Layout lq, Layout lk, Layout lv, Layout lo,
               int causal, float scale_log2) {
  using G = F32Geo<DH, BM>;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<DH, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // query blocks fastest, then heads: the qper heads that share a KV head
  // run next to each other and read its K and V from L2
  const dim3 grid((sq + BM - 1) / BM, H, b);
  fa_f32_kernel<DH, BM><<<grid, G::kThreads, G::kSmem, stream>>>(
      q, k, v, o, lse, sq, skv, qper, lq, lk, lv, lo, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// 64-row blocks at dh <= 64, three an SM (at whisper's (1, 1500) encoder
// 384 blocks fill the card once, where 128-row blocks left it short); at
// dh 128 128-row blocks, or 64-row ones when the 128-row grid would leave
// SMs idle
template <int DH>
int launch_f32_rows(cudaStream_t stream, const float* q, const float* k,
                    const float* v, float* o, float* lse, int b, int sq,
                    int skv, int H, int qper, Layout lq, Layout lk,
                    Layout lv, Layout lo, int causal, float scale_log2) {
  if constexpr (DH <= 64) {
    return launch_f32<DH, kF32RowsSmall>(stream, q, k, v, o, lse, b, sq,
                                         skv, H, qper, lq, lk, lv, lo,
                                         causal, scale_log2);
  } else {
    int device = 0, sms = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    const long long blocks =
        static_cast<long long>(b) * H * ((sq + kF32Rows - 1) / kF32Rows);
    if (blocks < static_cast<long long>(kF32SmallBelow) * sms)
      return launch_f32<DH, kF32RowsSmall>(stream, q, k, v, o, lse, b, sq,
                                           skv, H, qper, lq, lk, lv, lo,
                                           causal, scale_log2);
    return launch_f32<DH, kF32Rows>(stream, q, k, v, o, lse, b, sq, skv,
                                    H, qper, lq, lk, lv, lo, causal,
                                    scale_log2);
  }
}

}  // namespace

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int sq, int skv, int H, int KV, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, void* stream) {
  if (b <= 0 || sq <= 0 || H <= 0) return 0;
  const Layout lq{qsb, qss, qsh}, lk{ksb, kss, ksh}, lv{vsb, vss, vsh},
      lo{osb, oss, osh};
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(dh));
  auto s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  switch (dh) {
    case 32:
      return launch_bf16<32>(s, q, k, v, op, lp, b, sq, skv, H, KV, lq, lk, lv,
                             lo, causal, scale_log2);
    case 64:
      return launch_bf16<64>(s, q, k, v, op, lp, b, sq, skv, H, KV, lq, lk, lv,
                             lo, causal, scale_log2);
    case 128:
      return launch_bf16<128>(s, q, k, v, op, lp, b, sq, skv, H, KV, lq, lk, lv,
                              lo, causal, scale_log2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int sq, int skv, int H, int KV, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, void* stream) {
  if (b <= 0 || sq <= 0 || H <= 0) return 0;
  const Layout lq{qsb, qss, qsh}, lk{ksb, kss, ksh}, lv{vsb, vss, vsh},
      lo{osb, oss, osh};
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(dh));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  const int qper = H / KV;
  switch (dh) {
    case 32:
      return launch_f32_rows<32>(s, qp, kp, vp, op, lp, b, sq, skv, H, qper, lq,
                                 lk, lv, lo, causal, scale_log2);
    case 64:
      return launch_f32_rows<64>(s, qp, kp, vp, op, lp, b, sq, skv, H, qper, lq,
                                 lk, lv, lo, causal, scale_log2);
    case 128:
      return launch_f32_rows<128>(s, qp, kp, vp, op, lp, b, sq, skv, H, qper,
                                  lq, lk, lv, lo, causal, scale_log2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
