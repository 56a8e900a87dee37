// Mamba-1 selective scan over a (b, s, di) sequence with a (di, ds) state
// per sequence, float32 inside:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t        (di, ds)
//   y_t = sum_n C_t[n] * h_t[:, n]  (+ D * x_t when D is given)
// x and y are float32 or bfloat16 (y in x's type), dt float32 or bfloat16;
// A (di, ds), B and C (b, s, ds), D (di,), h0 and h_last (b, di, ds) are
// float32.  h0 may be null (zero state) and may be the same buffer as
// h_last (each state element is read, then written, by one thread).
// 1 <= ds <= 128, any s and di.  One launch per call.
// Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssm_scan.py, ssm_scan_pallas (_ssm_kernel), the
// TPU kernel that carries a (ds, 256) state tile in VMEM across a
// sequential grid axis of 64-step sequence blocks.
//
// Bound.  Prefill: operations, on the special-function units.  Every
// (step, channel, state) needs one exp (537 M at b=4, s=1024, di=8192,
// ds=16): at 16 a clock per SM, 132 SMs and 1,980 MHz that is 0.128 ms,
// against 0.081 ms to move the 270 MB of x and y (bf16) and dt (float32)
// at 3.35 TB/s.  The SFU takes one warp's exp every 8 clocks on each
// scheduler, so the kernel can reach that bound only while it dispatches
// fewer than 8 instructions for each (step, state).  Decode (s = 1):
// bytes, the state read and written once (5.1 MB at b=4), 0.0015 ms.
//
// Design (prefill).  A CTA owns CH = 64 channels of one sequence (CH *
// LANES threads; other ds than the model's take LANES at run time and
// CH = 256 / LANES); thread (channel c = tid % CH, lane = tid / CH) holds
// NS states of channel c in registers, with its row of A pre-scaled by
// log2(e).  The decay is then ex2.approx(dt * A'): one FMUL and one
// MUFU.EX2; the state update is fma(decay, h, dtx * B) and y's partial
// sum fma(C, h, acc): five instructions for each (step, state).  The
// sequence is cut into blocks of STEPS steps; a ring of kStages blocks in
// shared memory (x and dt rows CH channels wide, the B and C rows) is
// filled by 16-byte cp.async two blocks ahead of the one being computed.
// Full blocks are unrolled at compile time, so a block's decays and
// drives, which do not depend on h, are dispatched ahead of the one
// serial fma per step; the last block is masked.  B and C are read as
// broadcast float4 loads: the 32 threads of a warp are 32 channels of one
// lane.  A block's partial sums of y stay in registers to its last step
// (a shared-memory store between steps may alias the next step's loads,
// and the compiler then runs the steps one after another); then each
// thread stores them, and after the next block's barrier the CTA sums the
// LANES partials of each (step, channel) and writes y in 16-byte stores.
// One __syncthreads() per block, none per step.
//
// States a thread, measured on an H100 (chip_smoke.py phase 9 and
// tools/kernel_variants.py): the kernel is bound by its instruction
// count, not by the SFU (with the exp replaced by an FFMA it ran no
// faster), so fewer instructions a (step, state) beat more warps.  Eight
// states a thread (LANES = 2, 128 threads, 16-step blocks) spread the
// per-step loads of dt, x, B and C over eight states: 0.198 ms at
// (4, 1024), ~16 warps an SM, one wave.  At batch 1 that leaves 4 warps
// an SM, so the launch takes four states a thread (LANES = 4, 256
// threads, 32-step blocks) when eight would leave fewer than 12 warps an
// SM: 0.147 ms at (1, 2048, 8192, 16) with ~8 warps an SM, against 0.186
// ms with eight states and 0.161 ms with two states in 512-thread CTAs
// (~16 warps an SM, the per-step loads over only two states).  Splitting
// a block's steps across warps would also give ~16 warps an SM, but adds
// a decay product and a second pass per (step, state), 20 % more
// instructions in an instruction-bound loop; it is not done.  No exp is
// computed twice.
//
// Decode (s = 1): no shared memory and no barrier.  LANES = ds / 4
// neighbouring threads own a channel; each loads its four states of h0
// and A as float4, x, dt, D and its B and C as float4, writes h_last as
// float4 and sums y over the lanes with xor-shuffles.
//
// Multiplies and adds the model's math allows to fuse are __fmaf_rn; the
// rest are plain, and the library is built with --fmad=false, so nothing
// else is contracted.  The float32 result differs from the plain version
// in ex2.approx's last bits, the FMAs' single rounding and the order of
// the sum over states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;       // blocks in the shared-memory ring
constexpr float kLog2e = 1.4426950408889634f;

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

// NS (a multiple of 4) consecutive floats from 16-byte aligned shared
// memory
template <int NS>
__device__ __forceinline__ void lds_vec(float (&v)[NS], const float* p) {
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

// The shared-memory layout of one CTA: kStages stages of
//   x [steps][ch] (TX), dt [steps][ch] (TD), B, C [steps][dsp] (float)
// then two buffers of y partial sums [steps][lanes][ch] (float).  ch,
// lanes and dsp are powers of two; *_sh are their log2.
struct Layout {
  int steps, ch, lanes, dsp, threads, ch_sh, dsp_sh;
  size_t x_off, dt_off, b_off, c_off, stage, part_off, part, total;
  __host__ __device__ Layout(int steps_, int ch_, int lanes_, int ns, int ex,
                             int ed)
      : steps(steps_), ch(ch_), lanes(lanes_), dsp(lanes_ * ns),
        threads(ch_ * lanes_), ch_sh(0), dsp_sh(0) {
    while ((1 << ch_sh) < ch) ++ch_sh;
    while ((1 << dsp_sh) < dsp) ++dsp_sh;
    x_off = 0;
    dt_off = x_off + static_cast<size_t>(steps) * ch * ex;
    b_off = dt_off + static_cast<size_t>(steps) * ch * ed;
    c_off = b_off + static_cast<size_t>(steps) * dsp * 4;
    stage = c_off + static_cast<size_t>(steps) * dsp * 4;
    part_off = stage * kStages;
    part = static_cast<size_t>(steps) * threads * 4;
    total = part_off + 2 * part;
  }
};

template <typename TX, typename TD, int NS>
struct ScanArgs {
  const TX* x;
  const TD* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;
  const float* h0;
  TX* y;
  float* h_last;
  int s, di, ds, lanes;
  bool vec;                      // x, dt and y rows 16-byte aligned
  bool bc_vec;                   // B and C rows 16-byte aligned
};

template <int BYTES>
__host__ __device__ constexpr int log2_of() {
  return BYTES == 2 ? 1 : BYTES == 4 ? 2 : 3;
}

// Start the copies of block k (steps k * L.steps ...) into a shared stage.
template <typename TX, typename TD, int NS>
__device__ __forceinline__ void load_block(const ScanArgs<TX, TD, NS>& p,
                                           const Layout& L, char* stage,
                                           long long seq, int c0, int k) {
  const int t0 = k * L.steps;
  const int nt = min(L.steps, p.s - t0);
  const long long row0 = seq * p.s + t0;
  TX* sx = reinterpret_cast<TX*>(stage + L.x_off);
  TD* sdt = reinterpret_cast<TD*>(stage + L.dt_off);
  float* sb = reinterpret_cast<float*>(stage + L.b_off);
  float* sc = reinterpret_cast<float*>(stage + L.c_off);
  const int tid = threadIdx.x;
  if (p.vec) {
    // 16-byte chunks: 2^xs of them in a row of x, 2^ds_ of dt
    constexpr int VXS = 4 - log2_of<sizeof(TX)>();
    constexpr int VDS = 4 - log2_of<sizeof(TD)>();
    const int xs = L.ch_sh - VXS, ds_ = L.ch_sh - VDS;
#pragma unroll 1
    for (int e = tid; e < (L.steps << xs); e += L.threads) {
      const int t = e >> xs, cc = (e & ((1 << xs) - 1)) << VXS;
      if (t < nt && c0 + cc < p.di)
        cp_async16(sx + t * L.ch + cc, p.x + (row0 + t) * p.di + c0 + cc);
    }
#pragma unroll 1
    for (int e = tid; e < (L.steps << ds_); e += L.threads) {
      const int t = e >> ds_, cc = (e & ((1 << ds_) - 1)) << VDS;
      if (t < nt && c0 + cc < p.di)
        cp_async16(sdt + t * L.ch + cc, p.dt + (row0 + t) * p.di + c0 + cc);
    }
  } else {                       // unaligned rows: plain loads and stores
#pragma unroll 1
    for (int e = tid; e < (L.steps << L.ch_sh); e += L.threads) {
      const int t = e >> L.ch_sh, cc = e & (L.ch - 1);
      if (t < nt && c0 + cc < p.di) {
        const long long off = (row0 + t) * p.di + c0 + cc;
        sx[t * L.ch + cc] = p.x[off];
        sdt[t * L.ch + cc] = p.dt[off];
      }
    }
  }
  if (p.bc_vec) {                // ds % 4 == 0, so dsp >= 4
    const int bs = L.dsp_sh - 2;
#pragma unroll 1
    for (int e = tid; e < (nt << bs); e += L.threads) {
      const int t = e >> bs, n = (e & ((1 << bs) - 1)) << 2;
      if (n < p.ds) {
        cp_async16(sb + t * L.dsp + n, p.B + (row0 + t) * p.ds + n);
        cp_async16(sc + t * L.dsp + n, p.C + (row0 + t) * p.ds + n);
      }
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < (nt << L.dsp_sh); e += L.threads) {
      const int t = e >> L.dsp_sh, n = e & (L.dsp - 1);
      if (n < p.ds) {
        cp_async4(sb + t * L.dsp + n, p.B + (row0 + t) * p.ds + n);
        cp_async4(sc + t * L.dsp + n, p.C + (row0 + t) * p.ds + n);
      }
    }
  }
}

// Sum the lanes' partials of block k and write its y rows.
template <typename TX, typename TD, int NS>
__device__ __forceinline__ void store_block(const ScanArgs<TX, TD, NS>& p,
                                            const Layout& L,
                                            const float* part,
                                            long long seq, int c0, int k) {
  const int t0 = k * L.steps;
  const int nt = min(L.steps, p.s - t0);
  const long long row0 = seq * p.s + t0;
  const int tid = threadIdx.x;
  if (p.vec) {
    constexpr int V = 16 / sizeof(TX);     // channels per 16-byte store
    constexpr int VS = 4 - log2_of<sizeof(TX)>();
    const int vs = L.ch_sh - VS;
#pragma unroll 1
    for (int e = tid; e < (L.steps << vs); e += L.threads) {
      const int t = e >> vs, cc = (e & ((1 << vs) - 1)) << VS;
      if (t >= nt || c0 + cc >= p.di) continue;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int l = 0; l < L.lanes; ++l) {
        const float* src = part + (t * L.lanes + l) * L.ch + cc;
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(src + j);
          acc[j] += q.x; acc[j + 1] += q.y; acc[j + 2] += q.z;
          acc[j + 3] += q.w;
        }
      }
      __align__(16) TX out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = from_f<TX>(acc[j]);
      *reinterpret_cast<uint4*>(p.y + (row0 + t) * p.di + c0 + cc) =
          *reinterpret_cast<const uint4*>(out);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < (L.steps << L.ch_sh); e += L.threads) {
      const int t = e >> L.ch_sh, cc = e & (L.ch - 1);
      if (t >= nt || c0 + cc >= p.di) continue;
      float acc = 0.0f;
      for (int l = 0; l < L.lanes; ++l)
        acc += part[(t * L.lanes + l) * L.ch + cc];
      p.y[(row0 + t) * p.di + c0 + cc] = from_f<TX>(acc);
    }
  }
}

// The STEPS steps of a block for one thread's NS states from a stage.  The
// block's partial sums of y (lane 0 adds the skip term when SKIP; without
// it the first state's term is a multiply, not an FMA) stay in registers
// until the last step and are then stored to part[t][lane][channel]: a
// store between the steps would keep the next step's loads behind it.
template <bool FULL, bool SKIP, int STEPS, typename TX, typename TD,
          int NS>
__device__ __forceinline__ void scan_block(const Layout& L, const char* stage,
                                           float* part, int cl, int lane,
                                           int nt, const float (&a)[NS],
                                           float (&h)[NS], float d_skip) {
  const TX* sx = reinterpret_cast<const TX*>(stage + L.x_off);
  const TD* sdt = reinterpret_cast<const TD*>(stage + L.dt_off);
  const float* sb = reinterpret_cast<const float*>(stage + L.b_off);
  const float* sc = reinterpret_cast<const float*>(stage + L.c_off);
  const int n0 = lane * NS;
  float ys[STEPS];
#pragma unroll
  for (int t = 0; t < STEPS; ++t) {
    if (FULL || t < nt) {
      const float dtv = to_f(sdt[t * L.ch + cl]);
      const float xv = to_f(sx[t * L.ch + cl]);
      const float dtx = dtv * xv;
      float bv[NS], cv[NS];
      lds_vec<NS>(bv, sb + t * L.dsp + n0);
      lds_vec<NS>(cv, sc + t * L.dsp + n0);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float decay = ex2(dtv * a[j]);
        h[j] = __fmaf_rn(decay, h[j], dtx * bv[j]);
        if (j > 0)
          acc = __fmaf_rn(cv[j], h[j], acc);
        else
          acc = SKIP ? __fmaf_rn(cv[0], h[0], d_skip * xv) : cv[0] * h[0];
      }
      ys[t] = acc;
    }
  }
  float* out = part + lane * L.ch + cl;
  const int out_step = L.lanes * L.ch;
#pragma unroll
  for (int t = 0; t < STEPS; ++t)
    if (FULL || t < nt) out[t * out_step] = ys[t];
}

// LANES > 0 fixes the lanes of a channel at compile time (the layout's
// offsets then fold into the shared-memory addresses); 0 reads p.lanes.
// STEPS time steps a block.
template <typename TX, typename TD, int NS, int LANES, int THREADS,
          int STEPS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
ssm_scan_kernel(ScanArgs<TX, TD, NS> p) {
  extern __shared__ __align__(16) char smem[];
  const int lanes = LANES > 0 ? LANES : p.lanes;
  const Layout L(STEPS, THREADS / lanes, lanes, NS, sizeof(TX),
                 sizeof(TD));
  const long long seq = blockIdx.y;
  const int c0 = blockIdx.x * L.ch;
  const int tid = threadIdx.x;
  const int cl = tid % L.ch, lane = tid / L.ch;
  const int ch = c0 + cl;
  const bool live = ch < p.di;
  const int n0 = lane * NS;
  const long long hrow = (seq * p.di + ch) * p.ds;

  float a[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool ok = live && n0 + j < p.ds;
    a[j] = ok ? p.A[static_cast<long long>(ch) * p.ds + n0 + j] * kLog2e
              : 0.0f;
    h[j] = ok && p.h0 != nullptr ? p.h0[hrow + n0 + j] : 0.0f;
  }
  const float d_skip =
      live && lane == 0 && p.D != nullptr ? p.D[ch] : 0.0f;

  // the B and C columns past ds stay zero in every stage
  if (L.dsp > p.ds) {
    const int pad = L.dsp - p.ds;
    for (int e = tid; e < kStages * STEPS * pad; e += THREADS) {
      const int st = e / (STEPS * pad), r = e - st * STEPS * pad;
      const int t = r / pad, n = p.ds + r - t * pad;
      char* stage = smem + st * L.stage;
      reinterpret_cast<float*>(stage + L.b_off)[t * L.dsp + n] = 0.0f;
      reinterpret_cast<float*>(stage + L.c_off)[t * L.dsp + n] = 0.0f;
    }
  }

  const int nblk = (p.s + STEPS - 1) / STEPS;
  float* part = reinterpret_cast<float*>(smem + L.part_off);
  const int part_floats = static_cast<int>(L.part / 4);
#pragma unroll 1
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nblk) load_block(p, L, smem + k * L.stage, seq, c0, k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nblk; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // block k is in its stage; block k-1's stage and partials are free to
    // reuse and its partials are complete
    if (k > 0)
      store_block(p, L, part + ((k - 1) & 1) * part_floats, seq, c0, k - 1);
    const int kn = k + kStages - 1;
    if (kn < nblk) load_block(p, L, smem + (kn % kStages) * L.stage, seq, c0,
                              kn);
    cp_async_commit();
    const char* stage = smem + (k % kStages) * L.stage;
    float* mine = part + (k & 1) * part_floats;
    const int nt = min(STEPS, p.s - k * STEPS);
    if (nt == STEPS && p.D == nullptr)
      scan_block<true, false, STEPS, TX, TD, NS>(L, stage, mine, cl, lane,
                                                 nt, a, h, d_skip);
    else if (nt == STEPS)
      scan_block<true, true, STEPS, TX, TD, NS>(L, stage, mine, cl, lane,
                                                nt, a, h, d_skip);
    else
      scan_block<false, true, STEPS, TX, TD, NS>(L, stage, mine, cl, lane,
                                                 nt, a, h, d_skip);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (nblk > 0)
    store_block(p, L, part + ((nblk - 1) & 1) * part_floats, seq, c0,
                nblk - 1);
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (live && n0 + j < p.ds) p.h_last[hrow + n0 + j] = h[j];
}

// One step (s = 1): LANES neighbouring threads own a channel, four states
// each.
template <typename TX, typename TD>
__global__ void __launch_bounds__(256)
ssm_scan_step_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ C, const float* __restrict__ D,
                     const float* h0, TX* __restrict__ y, float* h_last,
                     int di, int ds, int lanes) {
  const long long seq = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ch = idx / lanes, lane = idx % lanes;
  const bool live = ch < di;
  const int n0 = lane * 4;
  const bool act = live && n0 < ds;     // lanes past ds hold no state
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dtv = 0.0f, xv = 0.0f;
  const long long hrow = (seq * di + ch) * ds + n0;
  const long long arow = static_cast<long long>(ch) * ds + n0;
  if (live) {
    dtv = to_f(dt[seq * di + ch]);
    xv = to_f(x[seq * di + ch]);
  }
  if (act) {
    if ((ds & 3) == 0) {
      const float4 qa = *reinterpret_cast<const float4*>(A + arow);
      const float4 qb = *reinterpret_cast<const float4*>(B + seq * ds + n0);
      const float4 qc = *reinterpret_cast<const float4*>(C + seq * ds + n0);
      a[0] = qa.x; a[1] = qa.y; a[2] = qa.z; a[3] = qa.w;
      bv[0] = qb.x; bv[1] = qb.y; bv[2] = qb.z; bv[3] = qb.w;
      cv[0] = qc.x; cv[1] = qc.y; cv[2] = qc.z; cv[3] = qc.w;
      if (h0 != nullptr) {
        const float4 qh = *reinterpret_cast<const float4*>(h0 + hrow);
        h[0] = qh.x; h[1] = qh.y; h[2] = qh.z; h[3] = qh.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < ds) {
          a[j] = A[arow + j];
          bv[j] = B[seq * ds + n0 + j];
          cv[j] = C[seq * ds + n0 + j];
          h[j] = h0 != nullptr ? h0[hrow + j] : 0.0f;
        }
      }
    }
  }
  const float dtx = dtv * xv;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float decay = ex2(dtv * (a[j] * kLog2e));
    h[j] = __fmaf_rn(decay, h[j], dtx * bv[j]);
    acc = __fmaf_rn(cv[j], h[j], acc);
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (act && (ds & 3) == 0) {
    *reinterpret_cast<float4*>(h_last + hrow) =
        make_float4(h[0], h[1], h[2], h[3]);
  } else if (act) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + j < ds) h_last[hrow + j] = h[j];
  }
  if (live && lane == 0)
    y[seq * di + ch] = from_f<TX>(D != nullptr ? __fmaf_rn(D[ch], xv, acc)
                                               : acc);
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TX, typename TD, int NS, int LANES, int THREADS,
          int STEPS>
int launch_scan(const ScanArgs<TX, TD, NS>& p, int batch,
                cudaStream_t stream) {
  const Layout L(STEPS, THREADS / p.lanes, p.lanes, NS, sizeof(TX),
                 sizeof(TD));
  auto kernel = ssm_scan_kernel<TX, TD, NS, LANES, THREADS, STEPS>;
  static size_t allowed = 48 << 10;
  if (L.total > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = L.total;
  }
  const dim3 grid((p.di + L.ch - 1) / L.ch, batch);
  kernel<<<grid, THREADS, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TD, int NS>
ScanArgs<TX, TD, NS> scan_args(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               const void* h0, void* y, void* h_last, int s,
                               int di, int ds) {
  ScanArgs<TX, TD, NS> p;
  p.x = static_cast<const TX*>(x);
  p.dt = static_cast<const TD*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(B);
  p.C = static_cast<const float*>(C);
  p.D = static_cast<const float*>(D);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<TX*>(y);
  p.h_last = static_cast<float*>(h_last);
  p.s = s;
  p.di = di;
  p.ds = ds;
  p.lanes = pow2_at_least((ds + NS - 1) / NS);
  p.vec = (static_cast<long long>(di) * sizeof(TX)) % 16 == 0 &&
          (static_cast<long long>(di) * sizeof(TD)) % 16 == 0 &&
          aligned16(x) && aligned16(dt) && aligned16(y);
  p.bc_vec = ds % 4 == 0 && aligned16(B) && aligned16(C);
  return p;
}

template <typename TX, typename TD>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y,
           void* h_last, int batch, int s, int di, int ds, void* stream) {
  if (batch <= 0 || di <= 0) return 0;
  if (ds <= 0 || ds > 128) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (s == 1) {
    const int lanes = pow2_at_least((ds + 3) / 4);
    const long long threads = static_cast<long long>(di) * lanes;
    const dim3 grid(static_cast<unsigned>((threads + 255) / 256), batch);
    ssm_scan_step_kernel<TX, TD><<<grid, 256, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TD*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<const float*>(D),
        static_cast<const float*>(h0), static_cast<TX*>(y),
        static_cast<float*>(h_last), di, ds, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  // ds <= 16 (the model's 16): eight states a thread in 16-step blocks
  // while that leaves at least 12 warps an SM, else four in 32-step blocks
  // (see the header); other ds: four states a thread, lanes at run time
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto p4 = scan_args<TX, TD, 4>(x, dt, A, B, C, D, h0, y, h_last, s, di,
                                 ds);
  if (ds > 8 && ds <= 16) {
    const long long warps8 = batch * ((di + 63LL) / 64) * (128 / 32);
    if (warps8 >= 12LL * sms)
      return launch_scan<TX, TD, 8, 2, 128, 16>(
          scan_args<TX, TD, 8>(x, dt, A, B, C, D, h0, y, h_last, s, di, ds),
          batch, st);
    return launch_scan<TX, TD, 4, 4, 256, 32>(p4, batch, st);
  }
  return launch_scan<TX, TD, 4, 0, 256, 16>(p4, batch, st);
}

}  // namespace

#define SSM_SCAN_ENTRY(NAME, TX, TD)                                        \
  extern "C" int NAME(const void* x, const void* dt, const void* A,        \
                      const void* B, const void* C, const void* D,         \
                      const void* h0, void* y, void* h_last, int batch,    \
                      int s, int di, int ds, void* stream) {               \
    return launch<TX, TD>(x, dt, A, B, C, D, h0, y, h_last, batch, s, di,  \
                          ds, stream);                                     \
  }

SSM_SCAN_ENTRY(ssm_scan_f32_f32, float, float)
SSM_SCAN_ENTRY(ssm_scan_f32_bf16, float, __nv_bfloat16)
SSM_SCAN_ENTRY(ssm_scan_bf16_f32, __nv_bfloat16, float)
SSM_SCAN_ENTRY(ssm_scan_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
