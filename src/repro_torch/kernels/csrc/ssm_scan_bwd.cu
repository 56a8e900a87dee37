// Backward of the Mamba-1 selective scan (ssm_scan.cu).  The forward, per
// sequence and channel c, with the state in float32:
//   a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t * x_t) * B_t   (di, ds)
//   y_t = sum_n C_t[n] * h_t[:, n]  (+ D * x_t when D is given)
// Given dy (b, s, di) in x's dtype and, optionally, dh_last (b, di, ds),
// the gradient of h_t from the future, read from t = s - 1 down, is
//   g_t = dy_t * C_t + a_{t+1} * g_{t+1},  seeded by dh_last,
// and the kernel writes, with q_t = g_t * h_{t-1} * a_t and the sums
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
// (channel tid / LANES, lane tid % LANES) holds kNS = 8 states of its
// channel (LANES = 2 for ds <= 16, 16 up to ds = 128), so the lanes of a
// channel are neighbours in a warp.  The sequence is staged in shared
// memory kStage = 32 steps at a time (x, dt, dy, B, C) and cut into
// blocks of kSteps = 8 steps.
//  1. Forward: the states are recomputed with the forward kernel's
//     arithmetic (ex2.approx of dt * A * log2(e), then one FMA), and the
//     state before each block is written to a workspace (the thread's own
//     words, coalesced), so the backward never runs a state backwards (a
//     division by a_t, which underflows when dt * A is very negative).
//  2. Reverse, block by block from the last: the block's 8 states are
//     recomputed from the saved start into registers, then the steps run
//     backwards with g and the running dA in registers.  s1 and s2 are
//     summed over a channel's lanes with xor-shuffles.  The dB and dC
//     terms (2 kNS values a thread and step) are summed over the warp's
//     channels by a halving butterfly: at each xor step a thread sends
//     half its values and keeps half, so 2 kNS values over 32 / LANES
//     threads cost 2 kNS - 1 shuffles instead of 2 kNS log2(32 / LANES).
//     Each step's dx, ddt and folded sum wait in registers until the
//     block's last step (a shared-memory store between the steps would
//     keep the next step's loads behind it); after each stage the CTA
//     writes dx, ddt and, summed over its warps in order, its partial of
//     dB and dC for each step.
//  3. A second kernel sums the partials in a fixed order: dB and dC over
//     the CTAs of a sequence's channels, dA and dD over the sequences.
// Measured on an H100 (PERF.md, section 6): the first design, 16-step blocks
// with the states in shared memory (96 KB a CTA) and each step's results
// stored as it ended, took 1.99 ms at (4, 1024, 8192, 16); this one 1.42
// ms (254 registers, 2 CTAs an SM).  Four states a thread (LANES = 4)
// took 1.60 ms there but 0.98 against 1.20 ms at batch 1, where eight
// states leave 128 CTAs for 132 SMs.  The time is latency: ~36
// instructions a (step, channel, state) at 8 warps an SM.
// No float atomics: two launches give the same bits.
//
// Multiplies and adds are fused only where written as __fmaf_rn; the
// library is built with --fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNS = 8;             // states a thread
constexpr int kThreads = 128;
constexpr int kSteps = 8;          // steps a block in registers, and
                                   // between saved states
constexpr int kStage = 32;         // steps staged in shared memory at once
constexpr int kWarps = kThreads / 32;
// threads a channel: for ds <= 16, and for ds <= 128 (a power of two)
constexpr int kSmallLanes = 16 / kNS;
constexpr int kBigLanes = 128 / kNS;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// kNS consecutive floats from 32-byte aligned shared memory
__device__ __forceinline__ void lds_states(float (&v)[kNS], const float* p) {
#pragma unroll
  for (int i = 0; i < kNS; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

// The shared memory of one CTA, in bytes from its start:
//   x, dt, dy, dx, ddt [kStage][ch]  (float)
//   B, C [kStage][dsp]             (dsp = lanes * kNS, zero past ds)
//   red  [kStage][kWarps][2][dsp]  each warp's sums of the dB, dC terms
struct BwdLayout {
  int lanes, ch, dsp;
  size_t dt_off, dy_off, dx_off, ddt_off, b_off, c_off, red_off, total;
  __host__ __device__ explicit BwdLayout(int lanes_)
      : lanes(lanes_), ch(kThreads / lanes_), dsp(lanes_ * kNS) {
    const size_t rows = static_cast<size_t>(kStage) * ch * 4;
    dt_off = rows;
    dy_off = 2 * rows;
    dx_off = 3 * rows;
    ddt_off = 4 * rows;
    b_off = 5 * rows;
    c_off = b_off + static_cast<size_t>(kStage) * dsp * 4;
    red_off = c_off + static_cast<size_t>(kStage) * dsp * 4;
    total = red_off + static_cast<size_t>(kStage) * kWarps * 2 * dsp * 4;
  }
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
  float* saved;          // [b][cta][block][kNS][kThreads]
  float* part_bc;        // [cta][2][b][s][ds]
  float* part_a;         // [b][di][ds]
  float* part_d;         // [b][di]
  int batch, s, di, ds;
};

// Stage the kStage steps from t0: x and dt (and, with ALL, dy and C) for
// the CTA's channels, B, each row past s and column past di or ds as 0.
template <bool ALL, int LANES, typename TX, typename TD>
__device__ __forceinline__ void stage_rows(const BwdArgs<TX, TD>& p,
                                           const BwdLayout& L, char* smem,
                                           long long seq, int c0, int t0) {
  constexpr int CH = kThreads / LANES;
  constexpr int DSP = LANES * kNS;
  const int nt = min(kStage, p.s - t0);
  const long long row0 = seq * p.s + t0;
  float* sx = reinterpret_cast<float*>(smem);
  float* sdt = reinterpret_cast<float*>(smem + L.dt_off);
  float* sdy = reinterpret_cast<float*>(smem + L.dy_off);
  float* sb = reinterpret_cast<float*>(smem + L.b_off);
  float* sc = reinterpret_cast<float*>(smem + L.c_off);
#pragma unroll 4
  for (int e = threadIdx.x; e < kStage * CH; e += kThreads) {
    const int t = e / CH, c = e % CH;
    const bool ok = t < nt && c0 + c < p.di;
    const long long off = (row0 + t) * p.di + c0 + c;
    sx[e] = ok ? to_f(p.x[off]) : 0.0f;
    sdt[e] = ok ? to_f(p.dt[off]) : 0.0f;
    if (ALL) sdy[e] = ok ? to_f(p.dy[off]) : 0.0f;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < kStage * DSP; e += kThreads) {
    const int t = e / DSP, n = e % DSP;
    const bool ok = t < nt && n < p.ds;
    const long long off = (row0 + t) * p.ds + n;
    sb[e] = ok ? p.B[off] : 0.0f;
    if (ALL) sc[e] = ok ? p.C[off] : 0.0f;
  }
}

// Sum each of a thread's CNT values over the threads of its warp that hold
// the same lane (xor offsets OFF, 2 OFF, ..., 16).  While a thread holds more
// than one value, each step sends half of them to its partner and keeps the
// other half (the upper half where the offset's bit is set), so afterwards
// v[i] holds the warp's sum of value fold_base(wl) + i for
// i < max(1, CNT * OFF / 32).
template <int CNT, int OFF, int N>
__device__ __forceinline__ void fold(float (&v)[N], int wl) {
  if constexpr (OFF < 32) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool up = (wl & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      fold<H, OFF * 2, N>(v, wl);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      fold<1, OFF * 2, N>(v, wl);
    }
  }
}

// The index of the first value a thread holds after fold<CNT, OFF>.
template <int CNT, int OFF>
__device__ __forceinline__ int fold_base(int wl) {
  if constexpr (OFF >= 32 || CNT <= 1)
    return 0;
  else
    return ((wl & OFF) ? CNT / 2 : 0) + fold_base<CNT / 2, OFF * 2>(wl);
}

template <int CNT, int OFF>
__host__ __device__ constexpr int folded() {
  if constexpr (OFF >= 32)
    return CNT;
  else
    return folded<(CNT > 1 ? CNT / 2 : 1), OFF * 2>();
}

// What one thread carries through the reverse pass.
struct Carry {
  float g[kNS];      // a_{t+1} g_{t+1}: the gradient of h_t from later
  float dA[kNS];
  float dD;
};

// One block of (up to) kSteps steps from stage row tb, backwards: the
// block's states recomputed from its saved start into registers, then the
// steps from the last, each step's dx, ddt and folded dB, dC sums kept in
// registers and stored after the block's last step (a shared-memory store
// between the steps would keep the next step's loads behind it).
template <bool FULL, int LANES>
__device__ __forceinline__ void reverse_block(
    const BwdLayout& L, char* smem, const float* start, int tb, int nt,
    const float (&a2)[kNS], Carry& cr, bool skip, float d_skip, int cl,
    int lane, int slot) {
  constexpr int CH = kThreads / LANES;
  constexpr int DSP = LANES * kNS;
  constexpr int V = 2 * kNS;                    // dB then dC terms
  constexpr int R = folded<V, LANES>();         // values left after fold
  const float* sx = reinterpret_cast<const float*>(smem);
  const float* sdt = reinterpret_cast<const float*>(smem + L.dt_off);
  const float* sdy = reinterpret_cast<const float*>(smem + L.dy_off);
  float* sdx = reinterpret_cast<float*>(smem + L.dx_off);
  float* sddt = reinterpret_cast<float*>(smem + L.ddt_off);
  const float* sb = reinterpret_cast<const float*>(smem + L.b_off);
  const float* sc = reinterpret_cast<const float*>(smem + L.c_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  const int n0 = lane * kNS;
  float h0[kNS], hs[kSteps][kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) h0[j] = start[j * kThreads + threadIdx.x];
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    if (FULL || t < nt) {
      const float dtv = sdt[(tb + t) * CH + cl];
      const float dtx = dtv * sx[(tb + t) * CH + cl];
      float bv[kNS];
      lds_states(bv, sb + (tb + t) * DSP + n0);
#pragma unroll
      for (int j = 0; j < kNS; ++j)
        hs[t][j] = __fmaf_rn(ex2(dtv * a2[j]), t > 0 ? hs[t - 1][j] : h0[j],
                             dtx * bv[j]);
    }
  }
  // the folded sums wait in registers when one value is left a thread (the
  // model's ds <= 16); more (ds > 16) are stored at once
  float gx[kSteps], gd[kSteps], rv[kSteps][1];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int t = kSteps - 1 - i;
    if (FULL || t < nt) {
      const float dtv = sdt[(tb + t) * CH + cl];
      const float xv = sx[(tb + t) * CH + cl];
      const float dyv = sdy[(tb + t) * CH + cl];
      const float dtx = dtv * xv;
      float bv[kNS], cv[kNS], v[V];
      lds_states(bv, sb + (tb + t) * DSP + n0);
      lds_states(cv, sc + (tb + t) * DSP + n0);
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const float hp = t > 0 ? hs[t - 1][j] : h0[j];
        const float a = ex2(dtv * a2[j]);
        const float g = __fmaf_rn(dyv, cv[j], cr.g[j]);
        v[j] = g * dtx;
        v[kNS + j] = dyv * hs[t][j];
        s1 = __fmaf_rn(g, bv[j], s1);
        const float q = g * hp * a;
        s2 = __fmaf_rn(q, a2[j], s2);          // A log2(e): see gd
        cr.dA[j] = __fmaf_rn(q, dtv, cr.dA[j]);
        cr.g[j] = a * g;
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const float gxv = dtv * s1;
      gx[t] = skip ? __fmaf_rn(d_skip, dyv, gxv) : gxv;
      gd[t] = __fmaf_rn(xv, s1, s2 * kLn2);
      cr.dD = __fmaf_rn(dyv, xv, cr.dD);
      const int wl = threadIdx.x % 32;
      fold<V, LANES>(v, wl);
      if constexpr (R == 1) {
        rv[t][0] = v[0];
      } else {
        const int base = fold_base<V, LANES>(wl);
        float* out = red + ((tb + t) * kWarps + threadIdx.x / 32) * 2 * DSP;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int idx = base + r;
          out[(idx / kNS) * DSP + n0 + idx % kNS] = v[r];
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    if (FULL || t < nt) {
      if (lane == 0) {
        sdx[(tb + t) * CH + cl] = gx[t];
        sddt[(tb + t) * CH + cl] = gd[t];
      }
      if constexpr (R == 1) red[(tb + t) * kWarps * 2 * DSP + slot] = rv[t][0];
    }
  }
}

template <typename TX, typename TD, int LANES>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(BwdArgs<TX, TD> p) {
  extern __shared__ __align__(16) char smem[];
  constexpr int CH = kThreads / LANES;
  constexpr int DSP = LANES * kNS;
  constexpr int V = 2 * kNS;
  const BwdLayout L(LANES);
  const int tid = threadIdx.x;
  const int cl = tid / LANES, lane = tid % LANES;
  const int warp = tid / 32, wl = tid % 32;
  const long long seq = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int ch = c0 + cl;
  const bool live = ch < p.di;
  const int n0 = lane * kNS;
  const long long hrow = (seq * p.di + ch) * p.ds;
  const float* sx = reinterpret_cast<const float*>(smem);
  const float* sdt = reinterpret_cast<const float*>(smem + L.dt_off);
  const float* sdx = reinterpret_cast<const float*>(smem + L.dx_off);
  const float* sddt = reinterpret_cast<const float*>(smem + L.ddt_off);
  const float* sb = reinterpret_cast<const float*>(smem + L.b_off);
  const float* red = reinterpret_cast<const float*>(smem + L.red_off);
  // where a thread's folded sum of each step goes in that step's row of
  // red, when one value is left a thread (the model's ds <= 16)
  const int base = fold_base<V, LANES>(wl);
  const int slot = warp * 2 * DSP + (base / kNS) * DSP + n0 + base % kNS;

  float a2[kNS], h[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    const bool ok = live && n0 + j < p.ds;
    a2[j] = ok ? p.A[static_cast<long long>(ch) * p.ds + n0 + j] * kLog2e
               : 0.0f;
    h[j] = ok && p.h0 != nullptr ? p.h0[hrow + n0 + j] : 0.0f;
  }
  const bool skip = p.D != nullptr;
  const float d_skip = live && skip ? p.D[ch] : 0.0f;
  const int nblk = (p.s + kSteps - 1) / kSteps;
  const int nstage = (p.s + kStage - 1) / kStage;
  float* saved = p.saved + (seq * gridDim.x + blockIdx.x) *
                               static_cast<long long>(nblk) * kNS * kThreads;

  // 1. forward: the state before each block into the workspace
#pragma unroll 1
  for (int c = 0; c < nstage; ++c) {
    __syncthreads();                 // the last stage's readers are done
    stage_rows<false, LANES>(p, L, smem, seq, c0, c * kStage);
    __syncthreads();
    const int ns = min(kStage, p.s - c * kStage);
#pragma unroll 1
    for (int tb = 0; tb < ns; tb += kSteps) {
      float* w = saved + static_cast<long long>((c * kStage + tb) / kSteps) *
                             kNS * kThreads;
#pragma unroll
      for (int j = 0; j < kNS; ++j) w[j * kThreads + tid] = h[j];
      const int nt = min(kSteps, ns - tb);
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        if (t < nt) {
          const float dtv = sdt[(tb + t) * CH + cl];
          const float dtx = dtv * sx[(tb + t) * CH + cl];
          float bv[kNS];
          lds_states(bv, sb + (tb + t) * DSP + n0);
#pragma unroll
          for (int j = 0; j < kNS; ++j)
            h[j] = __fmaf_rn(ex2(dtv * a2[j]), h[j], dtx * bv[j]);
        }
      }
    }
  }

  // 2. reverse, stage by stage and block by block
  Carry cr;
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    const bool ok = live && n0 + j < p.ds;
    cr.g[j] = ok && p.dh_last != nullptr ? p.dh_last[hrow + n0 + j] : 0.0f;
    cr.dA[j] = 0.0f;
  }
  cr.dD = 0.0f;
#pragma unroll 1
  for (int c = nstage - 1; c >= 0; --c) {
    const int ns = min(kStage, p.s - c * kStage);
    __syncthreads();                 // the last stage's write-out is done
    stage_rows<true, LANES>(p, L, smem, seq, c0, c * kStage);
    __syncthreads();
#pragma unroll 1
    for (int tb = ((ns - 1) / kSteps) * kSteps; tb >= 0; tb -= kSteps) {
      const float* w = saved +
          static_cast<long long>((c * kStage + tb) / kSteps) * kNS * kThreads;
      const int nt = min(kSteps, ns - tb);
      if (nt == kSteps)
        reverse_block<true, LANES>(L, smem, w, tb, nt, a2, cr, skip, d_skip,
                                   cl, lane, slot);
      else
        reverse_block<false, LANES>(L, smem, w, tb, nt, a2, cr, skip,
                                    d_skip, cl, lane, slot);
    }
    __syncthreads();
    // write the stage's dx and ddt, and the CTA's dB and dC partials
    const long long row0 = seq * p.s + static_cast<long long>(c) * kStage;
#pragma unroll 2
    for (int e = tid; e < ns * CH; e += kThreads) {
      const int t = e / CH, cc = e % CH;
      if (c0 + cc < p.di) {
        const long long off = (row0 + t) * p.di + c0 + cc;
        p.dx[off] = from_f<TX>(sdx[e]);
        p.ddt[off] = from_f<TD>(sddt[e]);
      }
    }
    const int per = 2 * p.ds;
#pragma unroll 1
    for (int e = tid; e < ns * per; e += kThreads) {
      const int t = e / per, r = e - t * per;
      const int qn = r / p.ds, n = r - qn * p.ds;
      float acc = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp)
        acc += red[((t * kWarps + wp) * 2 + qn) * DSP + n];
      p.part_bc[(((static_cast<long long>(blockIdx.x) * 2 + qn) * p.batch +
                  seq) * p.s + static_cast<long long>(c) * kStage + t) *
                    p.ds + n] = acc;
    }
  }
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (live && n0 + j < p.ds) {
      if (p.dh0 != nullptr) p.dh0[hrow + n0 + j] = cr.g[j];
      p.part_a[hrow + n0 + j] = cr.dA[j];
    }
  }
  if (p.part_d != nullptr && live && lane == 0)
    p.part_d[seq * p.di + ch] = cr.dD;
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

template <typename TX, typename TD, int LANES>
int launch_scan(const BwdArgs<TX, TD>& p, cudaStream_t st) {
  const BwdLayout L(LANES);
  auto kernel = ssm_scan_bwd_kernel<TX, TD, LANES>;
  static size_t allowed = 48 << 10;
  if (L.total > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = L.total;
  }
  const dim3 grid((p.di + L.ch - 1) / L.ch, p.batch);
  kernel<<<grid, kThreads, L.total, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// lanes: kSmallLanes (ds <= 16) or kBigLanes (ds <= 128), the wrapper's
// choice, which sizes its workspace: saved b * ctas * blocks * kNS *
// kThreads floats, then part_bc ctas * 2 * b * s * ds, part_a b * di * ds,
// part_d b * di, with ctas = ceil(di / (kThreads / lanes)) and blocks =
// ceil(s / kSteps).
template <typename TX, typename TD>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, const void* dy,
           const void* dh_last, void* dx, void* ddt, void* dA, void* dBC,
           void* dD, void* dh0, void* work, int batch, int s, int di, int ds,
           int lanes, void* stream) {
  if (batch <= 0 || s <= 0 || di <= 0) return 0;
  if (ds <= 0 || ds > lanes * kNS ||
      (lanes != kSmallLanes && lanes != kBigLanes))
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
  p.part_bc = p.saved + static_cast<long long>(batch) * ctas * blocks * kNS *
                            kThreads;
  p.part_a = p.part_bc + static_cast<long long>(ctas) * 2 * batch * s * ds;
  p.part_d = D != nullptr ? p.part_a + static_cast<long long>(batch) * di * ds
                          : nullptr;
  p.batch = batch;
  p.s = s;
  p.di = di;
  p.ds = ds;
  const int e = lanes == kSmallLanes
                    ? launch_scan<TX, TD, kSmallLanes>(p, st)
                    : launch_scan<TX, TD, kBigLanes>(p, st);
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
