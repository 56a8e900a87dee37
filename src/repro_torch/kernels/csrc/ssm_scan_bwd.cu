// Backward of the Mamba-1 selective scan (ssm_scan.cu).  The forward, per
// sequence and channel c, with the state in float32:
//   a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t * x_t) * B_t   (di, ds)
//   y_t = sum_n C_t[n] * h_t[:, n]  (+ D * x_t when D is given)
// Given dy (b, s, di) in x's dtype and, optionally, dh_last (b, di, ds),
// the gradient of h_t from the future, read from t = s - 1 down, is
//   g_t = dy_t * C_t + a_{t+1} * g_{t+1},  seeded by dh_last,
// and the kernel writes, with q_t = a_t g_t h_{t-1} and the sums
// s1_t = sum_n g_t B_t, s2_t = sum_n q_t A over each channel's states:
//   dx_t = dt_t s1_t (+ D dy_t)         ddt_t = x_t s1_t + s2_t
//   dB_t = sum_c g_t dt_t x_t            dC_t = sum_c dy_t h_t
//   dA = sum_{b,t} q_t dt_t              dD = sum_{b,t} dy_t x_t
//   dh0 = a_0 g_0
// dx in x's dtype, ddt in dt's, the rest float32.  x float32 or bfloat16,
// dt float32 or bfloat16; A (di, ds), B and C (b, s, ds), D (di,), h0 and
// dh_last (b, di, ds) float32.  D, h0 and dh_last may be null (no skip
// term, a zero start, no gradient into h_last); dD and dh0 are then not
// written.  1 <= ds <= 128, any s and di.  Two launches per call: the scan
// and the sums across CTAs.  Hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through jax.grad of its jnp
// scan (repro/models/ssm.py, the chunked lax.scan under jax.checkpoint),
// and its Pallas forward (repro/kernels/ssm_scan.py, ssm_scan_pallas) has
// no backward.  This is the gradient of the port's forward kernel.
//
// Bound: operations.  Per (step, channel, state) one exp (a_t, 537 M at
// b=4, s=1024, di=8192, ds=16: 0.128 ms on the special-function units)
// and 19 float32 operations (the state recomputed, g, the two sums over
// channels and two over states, q, dA, the carry): 10.2 GFLOP, 0.154 ms
// at 67 TFLOP/s, against 0.141 ms to move the 472 MB of x, dy and dx
// (bf16), dt and ddt (float32).  (kernels/ssm_scan.py, scan_bwd_work.)
//
// Design.  A CTA owns CH = 128 / LANES channels of one sequence; thread
// (channel tid / LANES, lane tid % LANES) holds NS states of its channel, so
// the lanes of a channel are neighbours in a warp.  Three layouts, chosen
// by the wrapper (kernels/ssm_scan.py, bwd_plan): eight states a thread
// (LANES 2, ds <= 16) while that grid gives every SM two CTAs, else four
// (LANES 4, ds <= 16, as at batch 1), and eight with LANES 16 up to ds =
// 128.  The sequence is cut into blocks of kSteps = 8 steps and staged in
// slots of kStage = 16 steps: a ring of kRing = 3 slots in shared memory,
// filled by cp.async two slots ahead of the one being computed (x, dt and
// dy in their own dtypes, converted at use; B and C; in the reverse pass
// the blocks' saved start states), with one __syncthreads() a slot.
//  1. Forward: the states are recomputed with the forward kernel's
//     arithmetic (ex2.approx of dt * A * log2(e), then one FMA), and the
//     state before each block is written to a workspace (the thread's own
//     words, coalesced), so the backward never runs a state backwards (a
//     division by a_t, which underflows when dt * A is very negative).
//  2. Reverse, slot by slot and block by block from the last: the block's
//     states are recomputed from the saved start into registers, then the
//     steps run backwards with g and the running dA in registers, each
//     computing its decays again (keeping them did not pay, below).  s1 and s2 are summed over a channel's lanes with
//     xor-shuffles.  The dB and dC terms are summed over the warp's
//     channels by a halving butterfly:
//     a thread holds its states with its float4 halves swapped where its
//     first xor step's lane bit is set, so at that step (half the
//     butterfly's shuffles) it always keeps its first four states and sends
//     the last four, with no select, and the kept products are fused into
//     the step's adds; the later steps select what they keep.  Each step's
//     dx, ddt and folded sum wait in registers until the block's last step;
//     then dx and ddt go to device memory from the channel's first lane,
//     and the folded sums to shared memory, summed over the CTA's warps
//     after the next slot's barrier.
//  3. A second kernel sums the partials in a fixed order: dB and dC over
//     the CTAs of a sequence's channels, dA and dD over the sequences.
// No float atomics: two launches give the same bits.
//
// Measured on an H100 (PERF.md, section 6; tools/kernel_variants.py, ms at
// (4, 1024, 8192, 16) with bf16 x and float32 dt, each variant against the
// shipped source in one run).  The previous design (a synchronous staging
// of 32 steps between two barriers, three exps a (step, channel, state), a
// butterfly with two selects a shuffle) took 1.43 in the same runs; this
// one 1.02-1.07 (15 % of the bound), 0.74-0.75 at (1, 2048) against
// 1.19.
// The ring with 8-step slots took it to 1.12, the first xor step without
// selects to 1.04, 16-step slots to 1.02-1.03.  Levers that lost or did
// not pay (the first two parts of each of the first two items measured on
// versions of this source that are not kept):
//  - the decays computed once into shared memory and read by the
//    recomputation and the reverse step (two exps instead of three): 1.30
//    against 1.12, its 3 KB of shared-memory traffic a warp and step cost
//    more than the exp it saved; kept in registers (variant decays_kept)
//    with 8-step blocks: 1.02-1.04 against 1.05-1.07 in the same runs, but
//    at 254-255 registers ptxas spills 8 bytes in one of its kernels, and
//    this kernel spills at no ds; with 4-step blocks (a saved state every
//    4 steps): 1.12-1.17;
//  - every xor step without selects (the states in the order n ^ m for a
//    3-bit lane mask m, B and C staged in four XOR-permuted copies): 1.11-
//    1.15, the copies' staging and 16 distinct addresses a load cost more
//    than the 12 selects a step they saved; every step selecting
//    (variant fold_selects): 1.04-1.12;
//  - a 2- or 4-slot ring, 32-step slots: no gain or slower;
//  - four states a thread at batch 4: 1.26-1.33; eight at (1, 2048):
//    0.92 against four's 0.75.
// The forward pass alone takes 0.24-0.27 ms, the butterfly 0.13-0.18.  The
// forward kernel could save the states every kSteps steps for the backward,
// but under remat the forward runs twice a training step and would write
// the 268 MB twice, and the bare call still needs this pass; it is not
// done.
//
// Multiplies and adds are fused only where written as __fmaf_rn; the
// library is built with --fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 8;          // steps a block: kept in registers, and
                                   // between saved states
constexpr int kStage = 16;         // steps a ring slot, kSub blocks
constexpr int kSub = kStage / kSteps;
constexpr int kRing = 3;           // slots in the shared-memory ring
constexpr int kWarps = kThreads / 32;
// the layouts, by threads a channel: eight states a thread (ds <= 16), four
// (ds <= 16), and eight up to ds = 128
constexpr int kEightLanes = 2;
constexpr int kFourLanes = 4;
constexpr int kWideLanes = 16;
// CTAs an SM each layout's registers are kept for (the wrapper takes the
// eight-state layout when its grid gives every SM kEightCtas)
constexpr int kEightCtas = 2;
constexpr int kFourCtas = 3;
constexpr int kWideCtas = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The butterfly's geometry for NS states a thread and LANES threads a
// channel: kFolds xor steps over the warp's channels (offsets LANES, 2
// LANES, ..., 16), the first kStateFolds halving a thread's states, then
// (kKindFold) one splitting dB from dC; kLeft values of each kind are left
// a thread (kOut values in all).
template <int NS, int LANES>
struct Geo {
  static constexpr int kCh = kThreads / LANES;    // channels a CTA
  static constexpr int kDsp = LANES * NS;         // states a channel
  static constexpr int kFolds = 5 - log2i(LANES);
  static constexpr int kStateFolds =
      kFolds < log2i(NS) ? kFolds : log2i(NS);
  static constexpr bool kKindFold = kFolds > log2i(NS);
  static constexpr int kLeft = NS >> kStateFolds;
  static constexpr int kOut = kKindFold ? 1 : 2 * kLeft;
  static_assert((NS == 4 || NS == 8) && kFolds <= log2i(NS) + 1, "layout");
};

// The shared memory of one CTA, in bytes from its start: kRing slots of
//   x, dt, dy [kStage][kCh] (their dtypes)
//   B, C [kStage][kDsp] (float, zero past ds)
//   saved [kSub][kThreads][NS] (float; the blocks' start states, reverse
//                               pass)
// then red [2][kStage][kWarps][2][kDsp], each warp's folded dB and dC
// sums of a slot (two slots).
template <typename TX, typename TD, int NS, int LANES>
struct Smem {
  using G = Geo<NS, LANES>;
  static constexpr size_t kX = 0;
  static constexpr size_t kDt = kX + size_t(kStage) * G::kCh * sizeof(TX);
  static constexpr size_t kDy = kDt + size_t(kStage) * G::kCh * sizeof(TD);
  static constexpr size_t kB = kDy + size_t(kStage) * G::kCh * sizeof(TX);
  static constexpr size_t kBC = size_t(kStage) * G::kDsp * 4;
  static constexpr size_t kC = kB + kBC;
  static constexpr size_t kSaved = kC + kBC;
  static constexpr size_t kSlot = kSaved + size_t(kSub) * kThreads * NS * 4;
  static constexpr size_t kRed = kSlot * kRing;
  static constexpr size_t kRedFloats = size_t(kStage) * kWarps * 2 * G::kDsp;
  static constexpr size_t kTotal = kRed + 2 * kRedFloats * 4;
  static_assert(kDt % 16 == 0 && kDy % 16 == 0 && kB % 16 == 0 &&
                kSlot % 16 == 0, "16-byte aligned regions");
};

template <typename TX, typename TD>
struct BwdArgs {
  const TX* x;
  const TD* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;        // null: no skip term, no dD
  const float* h0;       // null: a zero start
  const TX* dy;
  const float* dh_last;  // null: no gradient into h_last
  TX* dx;
  TD* ddt;
  float* dh0;            // null: not wanted
  float* saved;          // [b][cta][block][kThreads][NS]
  float* part_bc;        // [cta][2][b][s][ds]
  float* part_a;         // [b][di][ds]
  float* part_d;         // [b][di]
  int batch, s, di, ds;
  bool vec;              // x, dt and dy rows in 16-byte chunks
};

// Where a thread sits: its channel, lane, states (slot j holds state
// n0 + (j ^ m)) and, after the butterfly, its sums' place in red.
template <int NS, int LANES>
struct Thread {
  using G = Geo<NS, LANES>;
  int tid, cl, lane, wl, warp, n0, ch, base, m, slot;
  bool live;
  __device__ Thread(int c0, int di)
      : tid(threadIdx.x), cl(tid / LANES), lane(tid % LANES), wl(tid % 32),
        warp(tid / 32), n0(lane * NS), ch(c0 + tid / LANES) {
    live = ch < di;
    // the butterfly keeps, at xor step k, the upper half of the thread's
    // states where lane bit LANES << k is set: the first state left
    base = 0;
#pragma unroll
    for (int k = 0; k < G::kStateFolds; ++k)
      if (wl & (LANES << k)) base += NS >> (k + 1);
    // eight states: the float4 halves swapped where the first xor step's
    // lane bit is set, so that step keeps and sends fixed registers
    m = base & 4;
    const int kind =
        G::kKindFold && (wl & (LANES << G::kStateFolds)) ? 1 : 0;
    slot = kind * G::kDsp + n0 + base;
  }
  __device__ int state(int j) const { return n0 + (j ^ m); }
  // the position of slot 4 q's float4 in a step's row of B or C
  __device__ int group(int q) const { return n0 + ((4 * q) ^ m); }
};

// NS floats from 16-byte aligned shared memory
template <int NS>
__device__ __forceinline__ void lds_vec(float (&v)[NS], const float* p) {
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

// the thread's NS states of a step's row of B or C
template <int NS, int LANES>
__device__ __forceinline__ void lds_states(float (&v)[NS], const float* row,
                                           const Thread<NS, LANES>& th) {
#pragma unroll
  for (int q = 0; q < NS / 4; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(row + th.group(q));
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// Start the copies of slot k (steps k kStage ...) into a ring slot: x and
// dt (and, with ALL, dy, C and its blocks' saved start states) for the
// CTA's channels, and B.  Rows past s are not copied (never read); columns
// past di and B, C positions past ds were zeroed once.
template <bool ALL, typename TX, typename TD, int NS, int LANES>
__device__ __forceinline__ void load_block(const BwdArgs<TX, TD>& p,
                                           char* slot, long long seq, int c0,
                                           int k, const float* saved) {
  using G = Geo<NS, LANES>;
  using S = Smem<TX, TD, NS, LANES>;
  const int t0 = k * kStage;
  const int nt = min(kStage, p.s - t0);
  const long long row0 = seq * p.s + t0;
  const int tid = threadIdx.x;
  TX* sx = reinterpret_cast<TX*>(slot + S::kX);
  TD* sdt = reinterpret_cast<TD*>(slot + S::kDt);
  TX* sdy = reinterpret_cast<TX*>(slot + S::kDy);
  if (p.vec) {
    constexpr int VX = 16 / sizeof(TX), VD = 16 / sizeof(TD);
    constexpr int NX = G::kCh / VX, ND = G::kCh / VD;   // chunks a row
#pragma unroll 1
    for (int e = tid; e < kStage * NX; e += kThreads) {
      const int t = e / NX, cc = (e % NX) * VX;
      if (t < nt && c0 + cc < p.di) {
        const long long off = (row0 + t) * p.di + c0 + cc;
        cp_async16(sx + t * G::kCh + cc, p.x + off);
        if (ALL) cp_async16(sdy + t * G::kCh + cc, p.dy + off);
      }
    }
#pragma unroll 1
    for (int e = tid; e < kStage * ND; e += kThreads) {
      const int t = e / ND, cc = (e % ND) * VD;
      if (t < nt && c0 + cc < p.di)
        cp_async16(sdt + t * G::kCh + cc, p.dt + (row0 + t) * p.di + c0 + cc);
    }
  } else {                       // unaligned rows: plain loads and stores
#pragma unroll 1
    for (int e = tid; e < kStage * G::kCh; e += kThreads) {
      const int t = e / G::kCh, cc = e % G::kCh;
      if (t < nt && c0 + cc < p.di) {
        const long long off = (row0 + t) * p.di + c0 + cc;
        sx[e] = p.x[off];
        sdt[e] = p.dt[off];
        if (ALL) sdy[e] = p.dy[off];
      }
    }
  }
  float* sb = reinterpret_cast<float*>(slot + S::kB);
  float* sc = reinterpret_cast<float*>(slot + S::kC);
#pragma unroll 1
  for (int e = tid; e < kStage * G::kDsp; e += kThreads) {
    const int t = e / G::kDsp, n = e % G::kDsp;
    if (t < nt && n < p.ds) {
      const long long off = (row0 + t) * p.ds + n;
      cp_async4(sb + e, p.B + off);
      if (ALL) cp_async4(sc + e, p.C + off);
    }
  }
  if (ALL) {
    const float* src =
        saved + static_cast<long long>(k) * kSub * kThreads * NS;
    float* dst = reinterpret_cast<float*>(slot + S::kSaved);
#pragma unroll 1
    for (int e = tid; e < kSub * kThreads * NS / 4; e += kThreads)
      if (e / (kThreads * NS / 4) * kSteps < nt)
        cp_async16(dst + 4 * e, src + 4 * e);
  }
}

// Zero, in every ring slot, the B and C positions whose state is past ds
// and the columns of channels past di: no cp.async ever writes them.
template <typename TX, typename TD, int NS, int LANES>
__device__ __forceinline__ void zero_pads(const BwdArgs<TX, TD>& p,
                                          char* smem, int c0) {
  using G = Geo<NS, LANES>;
  using S = Smem<TX, TD, NS, LANES>;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int r = 0; r < kRing; ++r) {
    char* slot = smem + r * S::kSlot;
    float* sb = reinterpret_cast<float*>(slot + S::kB);
    float* sc = reinterpret_cast<float*>(slot + S::kC);
    if (G::kDsp > p.ds) {
#pragma unroll 1
      for (int e = tid; e < kStage * G::kDsp; e += kThreads) {
        if (e % G::kDsp >= p.ds) {
          sb[e] = 0.0f;
          sc[e] = 0.0f;
        }
      }
    }
    if (c0 + G::kCh > p.di) {
      TX* sx = reinterpret_cast<TX*>(slot + S::kX);
      TD* sdt = reinterpret_cast<TD*>(slot + S::kDt);
      TX* sdy = reinterpret_cast<TX*>(slot + S::kDy);
#pragma unroll 1
      for (int e = tid; e < kStage * G::kCh; e += kThreads) {
        if (c0 + e % G::kCh >= p.di) {
          sx[e] = from_f<TX>(0.0f);
          sdt[e] = from_f<TD>(0.0f);
          sdy[e] = from_f<TX>(0.0f);
        }
      }
    }
  }
}

// the value a thread keeps (of its lower and upper halves) at a xor step,
// and the one it sends: where the step halves swapped states (fixed),
// always the lower and the upper; else the upper half is kept where the
// step's lane bit is set
__device__ __forceinline__ float keep_of(bool fixed, bool up, float lo,
                                         float hi) {
  return !fixed && up ? hi : lo;
}
__device__ __forceinline__ float send_of(bool fixed, bool up, float lo,
                                         float hi) {
  return !fixed && up ? lo : hi;
}

// Sum a step's dB terms g dtx and dC terms h dy over the warp's channels
// (Geo's butterfly).  out: with kKindFold the thread's one sum (dB of state
// base where its kind bit is clear, else dC); else the kLeft dB sums of
// states base ... base + kLeft - 1, then their dC sums.
template <int NS, int LANES>
__device__ __forceinline__ void fold(const float (&g)[NS],
                                     const float (&h)[NS], float dtx,
                                     float dy, int wl,
                                     float (&out)[Geo<NS, LANES>::kOut]) {
  using G = Geo<NS, LANES>;
  constexpr int H0 = NS / 2;
  float vb[H0], vc[H0];
  {
    constexpr bool fixed = H0 == 4;      // eight states (Thread's m)
    const bool up = (wl & LANES) != 0;
#pragma unroll
    for (int j = 0; j < H0; ++j) {
      const float sb = send_of(fixed, up, g[j], g[j + H0]) * dtx;
      const float sc = send_of(fixed, up, h[j], h[j + H0]) * dy;
      vb[j] = __fmaf_rn(keep_of(fixed, up, g[j], g[j + H0]), dtx,
                        __shfl_xor_sync(kFull, sb, LANES));
      vc[j] = __fmaf_rn(keep_of(fixed, up, h[j], h[j + H0]), dy,
                        __shfl_xor_sync(kFull, sc, LANES));
    }
  }
#pragma unroll
  for (int k = 1; k < G::kStateFolds; ++k) {      // these steps select
    const int hh = NS >> (k + 1);
    const int off = LANES << k;
    const bool up = (wl & off) != 0;
#pragma unroll
    for (int j = 0; j < hh; ++j) {
      vb[j] = keep_of(false, up, vb[j], vb[j + hh]) +
              __shfl_xor_sync(kFull, send_of(false, up, vb[j], vb[j + hh]),
                              off);
      vc[j] = keep_of(false, up, vc[j], vc[j + hh]) +
              __shfl_xor_sync(kFull, send_of(false, up, vc[j], vc[j + hh]),
                              off);
    }
  }
  if constexpr (G::kKindFold) {
    constexpr int off = LANES << G::kStateFolds;
    const bool up = (wl & off) != 0;
    out[0] = (up ? vc[0] : vb[0]) +
             __shfl_xor_sync(kFull, up ? vb[0] : vc[0], off);
  } else {
#pragma unroll
    for (int j = 0; j < G::kLeft; ++j) {
      out[j] = vb[j];
      out[G::kLeft + j] = vc[j];
    }
  }
}

// The forward pass over one block of (up to) kSteps steps from slot row tb.
template <bool FULL, typename TX, typename TD, int NS, int LANES>
__device__ __forceinline__ void forward_block(const Thread<NS, LANES>& th,
                                              const char* slot, int tb,
                                              int nt, const float (&a2)[NS],
                                              float (&h)[NS]) {
  using G = Geo<NS, LANES>;
  using S = Smem<TX, TD, NS, LANES>;
  const TX* sx = reinterpret_cast<const TX*>(slot + S::kX) + tb * G::kCh;
  const TD* sdt = reinterpret_cast<const TD*>(slot + S::kDt) + tb * G::kCh;
  const float* sb = reinterpret_cast<const float*>(slot + S::kB) +
                    tb * G::kDsp;
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    if (FULL || t < nt) {
      const float dtv = to_f(sdt[t * G::kCh + th.cl]);
      const float dtx = dtv * to_f(sx[t * G::kCh + th.cl]);
      float bv[NS];
      lds_states(bv, sb + t * G::kDsp, th);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        h[j] = __fmaf_rn(ex2(dtv * a2[j]), h[j], dtx * bv[j]);
    }
  }
}

// What one thread carries through the reverse pass.
template <int NS>
struct Carry {
  float g[NS];      // a_{t+1} g_{t+1}: the gradient of h_t from later
  float dA[NS];
  float dD;
};

// One block of (up to) kSteps steps from slot row tb, backwards: its
// states recomputed from its saved start into registers, then the steps
// from the last (each computing its decays again),
// each step's dx, ddt and folded dB, dC sums kept in registers and stored
// after the block's last step (a shared-memory store between the steps
// would keep the next step's loads behind it).
template <bool FULL, typename TX, typename TD, int NS, int LANES>
__device__ __forceinline__ void reverse_block(
    const BwdArgs<TX, TD>& p, const Thread<NS, LANES>& th, const char* slot,
    const float* start, float* red, int tb, long long row0, int nt,
    const float (&a2)[NS], Carry<NS>& cr, float d_skip) {
  using G = Geo<NS, LANES>;
  using S = Smem<TX, TD, NS, LANES>;
  constexpr int CH = G::kCh;
  const TX* sx = reinterpret_cast<const TX*>(slot + S::kX) + tb * CH;
  const TD* sdt = reinterpret_cast<const TD*>(slot + S::kDt) + tb * CH;
  const TX* sdy = reinterpret_cast<const TX*>(slot + S::kDy) + tb * CH;
  const float* sb = reinterpret_cast<const float*>(slot + S::kB) +
                    tb * G::kDsp;
  const float* sc = reinterpret_cast<const float*>(slot + S::kC) +
                    tb * G::kDsp;
  const int cl = th.cl;
  float h0[NS], hs[kSteps][NS];
  lds_vec(h0, start);
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    if (FULL || t < nt) {
      const float dtv = to_f(sdt[t * CH + cl]);
      const float dtx = dtv * to_f(sx[t * CH + cl]);
      float bv[NS];
      lds_states(bv, sb + t * G::kDsp, th);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float a = ex2(dtv * a2[j]);
        hs[t][j] = __fmaf_rn(a, t > 0 ? hs[t - 1][j] : h0[j], dtx * bv[j]);
      }
    }
  }
  float gx[kSteps], gd[kSteps], rv[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int t = kSteps - 1 - i;
    if (FULL || t < nt) {
      const float dtv = to_f(sdt[t * CH + cl]);
      const float xv = to_f(sx[t * CH + cl]);
      const float dyv = to_f(sdy[t * CH + cl]);
      const float dtx = dtv * xv;
      float bv[NS], cv[NS], g[NS];
      lds_states(bv, sb + t * G::kDsp, th);
      lds_states(cv, sc + t * G::kDsp, th);
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float a = ex2(dtv * a2[j]);           // a_t, once more
        g[j] = __fmaf_rn(dyv, cv[j], cr.g[j]);
        s1 = __fmaf_rn(g[j], bv[j], s1);
        const float w = a * g[j];                     // the next carry
        const float q = w * (t > 0 ? hs[t - 1][j] : h0[j]);
        s2 = __fmaf_rn(q, a2[j], s2);                 // A log2(e): see gd
        cr.dA[j] = __fmaf_rn(q, dtv, cr.dA[j]);
        cr.g[j] = w;
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
        s1 += __shfl_xor_sync(kFull, s1, off);
        s2 += __shfl_xor_sync(kFull, s2, off);
      }
      const float gxv = dtv * s1;
      gx[t] = p.D != nullptr ? __fmaf_rn(d_skip, dyv, gxv) : gxv;
      gd[t] = __fmaf_rn(xv, s1, s2 * kLn2);
      cr.dD = __fmaf_rn(dyv, xv, cr.dD);
      float out[G::kOut];
      fold<NS, LANES>(g, hs[t], dtx, dyv, th.wl, out);
      if constexpr (G::kKindFold) {
        rv[t] = out[0];
      } else {           // ds > 16: several sums a thread, stored at once
        float* row = red + ((tb + t) * kWarps + th.warp) * 2 * G::kDsp +
                     th.n0 + th.base;
#pragma unroll
        for (int j = 0; j < G::kLeft; ++j) {
          row[j] = out[j];
          row[G::kDsp + j] = out[G::kLeft + j];
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    if (FULL || t < nt) {
      if (th.lane == 0 && th.live) {
        const long long off = (row0 + t) * p.di + th.ch;
        p.dx[off] = from_f<TX>(gx[t]);
        p.ddt[off] = from_f<TD>(gd[t]);
      }
      if constexpr (G::kKindFold)
        red[((tb + t) * kWarps + th.warp) * 2 * G::kDsp + th.slot] = rv[t];
    }
  }
}

// The CTA's dB and dC partials of slot k: each warp's folded sums in red
// added in warp order.
template <typename TX, typename TD, int NS, int LANES>
__device__ __forceinline__ void write_partials(const BwdArgs<TX, TD>& p,
                                               const float* red,
                                               long long seq, int k) {
  using G = Geo<NS, LANES>;
  const int t0 = k * kStage;
  const int nt = min(kStage, p.s - t0);
  const int per = 2 * p.ds;
#pragma unroll 1
  for (int e = threadIdx.x; e < nt * per; e += kThreads) {
    const int t = e / per, r = e - t * per;
    const int kind = r >= p.ds ? 1 : 0, n = r - kind * p.ds;
    const float* col = red + t * kWarps * 2 * G::kDsp + kind * G::kDsp + n;
    float acc = col[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += col[w * 2 * G::kDsp];
    p.part_bc[(((static_cast<long long>(blockIdx.x) * 2 + kind) * p.batch +
                seq) * p.s + t0 + t) * p.ds + n] = acc;
  }
}

template <typename TX, typename TD, int NS, int LANES, int CTAS>
__global__ void __launch_bounds__(kThreads, CTAS)
ssm_scan_bwd_kernel(BwdArgs<TX, TD> p) {
  extern __shared__ __align__(16) char smem[];
  using G = Geo<NS, LANES>;
  using S = Smem<TX, TD, NS, LANES>;
  const long long seq = blockIdx.y;
  const int c0 = blockIdx.x * G::kCh;
  const Thread<NS, LANES> th(c0, p.di);
  const long long hrow = (seq * p.di + th.ch) * p.ds;

  float a2[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = th.state(j);
    const bool ok = th.live && n < p.ds;
    a2[j] = ok ? p.A[static_cast<long long>(th.ch) * p.ds + n] * kLog2e
               : 0.0f;
    h[j] = ok && p.h0 != nullptr ? p.h0[hrow + n] : 0.0f;
  }
  const float d_skip = th.live && p.D != nullptr ? p.D[th.ch] : 0.0f;
  zero_pads<TX, TD, NS, LANES>(p, smem, c0);
  const int nblk = (p.s + kSteps - 1) / kSteps;
  const int nslot = (p.s + kStage - 1) / kStage;
  float* saved = p.saved + (seq * gridDim.x + blockIdx.x) *
                               static_cast<long long>(nblk) * kThreads * NS;
  float* red = reinterpret_cast<float*>(smem + S::kRed);

  // 1. forward: the state before each block into the workspace
#pragma unroll 1
  for (int k = 0; k < kRing - 1; ++k) {
    if (k < nslot)
      load_block<false, TX, TD, NS, LANES>(p, smem + k * S::kSlot, seq, c0,
                                           k, saved);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nslot; ++k) {
    cp_async_wait<kRing - 2>();
    __syncthreads();             // slot k is in; slot k - 1's ring slot free
    const int kn = k + kRing - 1;
    if (kn < nslot)
      load_block<false, TX, TD, NS, LANES>(p, smem + (kn % kRing) * S::kSlot,
                                           seq, c0, kn, saved);
    cp_async_commit();
    const char* slot = smem + (k % kRing) * S::kSlot;
    const int ns = min(kStage, p.s - k * kStage);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int tb = i * kSteps;
      if (tb < ns) {
        float4* w = reinterpret_cast<float4*>(
            saved + (static_cast<long long>(k * kSub + i) * kThreads +
                     th.tid) * NS);
#pragma unroll
        for (int q = 0; q < NS / 4; ++q)
          w[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                             h[4 * q + 3]);
        const int nt = min(kSteps, ns - tb);
        if (nt == kSteps)
          forward_block<true, TX, TD>(th, slot, tb, nt, a2, h);
        else
          forward_block<false, TX, TD>(th, slot, tb, nt, a2, h);
      }
    }
  }
  cp_async_wait<0>();
  __threadfence();               // the saved states before their async reads
  __syncthreads();

  // 2. reverse, slot by slot and block by block
  Carry<NS> cr;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = th.state(j);
    const bool ok = th.live && n < p.ds;
    cr.g[j] = ok && p.dh_last != nullptr ? p.dh_last[hrow + n] : 0.0f;
    cr.dA[j] = 0.0f;
  }
  cr.dD = 0.0f;
#pragma unroll 1
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < nslot)
      load_block<true, TX, TD, NS, LANES>(p, smem + i * S::kSlot, seq, c0,
                                          nslot - 1 - i, saved);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < nslot; ++i) {
    const int k = nslot - 1 - i;
    cp_async_wait<kRing - 2>();
    __syncthreads();             // slot k is in; slot k + 1's ring slot free
                                 // and its folded sums complete
    if (i > 0)
      write_partials<TX, TD, NS, LANES>(p, red + ((i - 1) & 1) *
                                                     S::kRedFloats, seq,
                                        k + 1);
    const int kn = k - (kRing - 1);
    if (kn >= 0)
      load_block<true, TX, TD, NS, LANES>(
          p, smem + ((i + kRing - 1) % kRing) * S::kSlot, seq, c0, kn, saved);
    cp_async_commit();
    const char* slot = smem + (i % kRing) * S::kSlot;
    const float* starts = reinterpret_cast<const float*>(slot + S::kSaved) +
                          th.tid * NS;
    float* rb = red + (i & 1) * S::kRedFloats;
    const int ns = min(kStage, p.s - k * kStage);
#pragma unroll
    for (int u = kSub - 1; u >= 0; --u) {
      const int tb = u * kSteps;
      if (tb < ns) {
        const long long row0 = seq * p.s + static_cast<long long>(k) *
                                               kStage + tb;
        const int nt = min(kSteps, ns - tb);
        const float* start = starts + u * kThreads * NS;
        if (nt == kSteps)
          reverse_block<true>(p, th, slot, start, rb, tb, row0, nt, a2, cr,
                              d_skip);
        else
          reverse_block<false>(p, th, slot, start, rb, tb, row0, nt, a2, cr,
                               d_skip);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  write_partials<TX, TD, NS, LANES>(p, red + ((nslot - 1) & 1) *
                                                 S::kRedFloats, seq, 0);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = th.state(j);
    if (th.live && n < p.ds) {
      if (p.dh0 != nullptr) p.dh0[hrow + n] = cr.g[j];
      p.part_a[hrow + n] = cr.dA[j];
    }
  }
  if (p.part_d != nullptr && th.live && th.lane == 0)
    p.part_d[seq * p.di + th.ch] = cr.dD;
}

// out[i] = sum over k < parts of part[k * count + i], k in order; three
// such sums, one a blockIdx.y
struct Sum {
  const float* part;
  float* out;
  long long count;
  int parts;
};

__global__ void __launch_bounds__(256)
ssm_scan_bwd_sum_kernel(Sum s0, Sum s1, Sum s2) {
  const Sum sm = blockIdx.y == 0 ? s0 : blockIdx.y == 1 ? s1 : s2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < sm.count; i += stride) {
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < sm.parts; ++k) acc += sm.part[k * sm.count + i];
    sm.out[i] = acc;
  }
}

template <typename TX, typename TD, int NS, int LANES, int CTAS>
int launch_scan(const BwdArgs<TX, TD>& p, cudaStream_t st) {
  constexpr size_t bytes = Smem<TX, TD, NS, LANES>::kTotal;
  auto kernel = ssm_scan_bwd_kernel<TX, TD, NS, LANES, CTAS>;
  static size_t allowed = 48 << 10;
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  const dim3 grid((p.di + Geo<NS, LANES>::kCh - 1) / Geo<NS, LANES>::kCh,
                  p.batch);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// lanes: kEightLanes or kFourLanes (ds <= 16), kWideLanes (ds <= 128), the
// wrapper's plan (kernels/ssm_scan.py, bwd_plan), which sizes its
// workspace: saved b * ctas * blocks * kThreads * states floats, then
// part_bc ctas * 2 * b * s * ds, part_a b * di * ds, part_d b * di, with
// ctas = ceil(di / (kThreads / lanes)) and blocks = ceil(s / kSteps).
template <typename TX, typename TD>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, const void* dy,
           const void* dh_last, void* dx, void* ddt, void* dA, void* dBC,
           void* dD, void* dh0, void* work, int batch, int s, int di, int ds,
           int lanes, void* stream) {
  if (batch <= 0 || s <= 0 || di <= 0) return 0;
  const int states = lanes == kFourLanes ? 4 : 8;
  if ((lanes != kEightLanes && lanes != kFourLanes && lanes != kWideLanes) ||
      ds <= 0 || ds > lanes * states)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int ctas = (di + kThreads / lanes - 1) / (kThreads / lanes);
  const long long blocks = (s + kSteps - 1) / kSteps;
  BwdArgs<TX, TD> p;
  p.x = static_cast<const TX*>(x);
  p.dt = static_cast<const TD*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(B);
  p.C = static_cast<const float*>(C);
  p.D = static_cast<const float*>(D);
  p.h0 = static_cast<const float*>(h0);
  p.dy = static_cast<const TX*>(dy);
  p.dh_last = static_cast<const float*>(dh_last);
  p.dx = static_cast<TX*>(dx);
  p.ddt = static_cast<TD*>(ddt);
  p.dh0 = static_cast<float*>(dh0);
  p.saved = static_cast<float*>(work);
  p.part_bc = p.saved + static_cast<long long>(batch) * ctas * blocks *
                            kThreads * states;
  p.part_a = p.part_bc + static_cast<long long>(ctas) * 2 * batch * s * ds;
  p.part_d = D != nullptr ? p.part_a + static_cast<long long>(batch) * di * ds
                          : nullptr;
  p.batch = batch;
  p.s = s;
  p.di = di;
  p.ds = ds;
  p.vec = (static_cast<long long>(di) * sizeof(TX)) % 16 == 0 &&
          (static_cast<long long>(di) * sizeof(TD)) % 16 == 0 &&
          aligned16(x) && aligned16(dt) && aligned16(dy);
  const int e =
      lanes == kEightLanes
          ? launch_scan<TX, TD, 8, kEightLanes, kEightCtas>(p, st)
      : lanes == kFourLanes
          ? launch_scan<TX, TD, 4, kFourLanes, kFourCtas>(p, st)
          : launch_scan<TX, TD, 8, kWideLanes, kWideCtas>(p, st);
  if (e != 0) return e;
  const Sum s0{p.part_bc, static_cast<float*>(dBC),
               2LL * batch * s * ds, ctas};
  const Sum s1{p.part_a, static_cast<float*>(dA),
               static_cast<long long>(di) * ds, batch};
  const Sum s2{p.part_d, static_cast<float*>(dD),
               D != nullptr ? di : 0, batch};
  long long most = s0.count > s1.count ? s0.count : s1.count;
  long long nb = (most + 255) / 256;
  if (nb > 132 * 8) nb = 132 * 8;
  ssm_scan_bwd_sum_kernel<<<dim3(static_cast<unsigned>(nb), 3), 256, 0, st>>>(
      s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SSM_SCAN_BWD_ENTRY(NAME, TX, TD)                                     \
  extern "C" int NAME(const void* x, const void* dt, const void* A,         \
                      const void* B, const void* C, const void* D,          \
                      const void* h0, const void* dy, const void* dh_last,  \
                      void* dx, void* ddt, void* dA, void* dBC, void* dD,   \
                      void* dh0, void* work, int batch, int s, int di,      \
                      int ds, int lanes, void* stream) {                    \
    return launch<TX, TD>(x, dt, A, B, C, D, h0, dy, dh_last, dx, ddt, dA,  \
                          dBC, dD, dh0, work, batch, s, di, ds, lanes,      \
                          stream);                                          \
  }

SSM_SCAN_BWD_ENTRY(ssm_scan_bwd_f32_f32, float, float)
SSM_SCAN_BWD_ENTRY(ssm_scan_bwd_f32_bf16, float, __nv_bfloat16)
SSM_SCAN_BWD_ENTRY(ssm_scan_bwd_bf16_f32, __nv_bfloat16, float)
SSM_SCAN_BWD_ENTRY(ssm_scan_bwd_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
