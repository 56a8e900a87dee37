// RMSNorm over the rows of an (n, d) block:
//   y = x * rsqrt(mean(x^2) + eps) * scale, statistics in float32, cast to
// x's type.  x and y are float32 or bfloat16; scale is float32 or bfloat16.
// Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/rmsnorm.py, rmsnorm_pallas (_rmsnorm_kernel), the
// TPU kernel that normalises a 256-row tile per grid step in VMEM.
//
// Bound: bytes.  Each element is read once and written once (2 B + 2 B in
// bfloat16, plus the d-element scale), against three float operations per
// element; a (4000, 4096) bfloat16 block needs 19.6 us at 3.35 TB/s.
//
// Design: one 256-thread CTA per row, with x read from device memory once:
// each thread keeps up to 8 of the row's 16-byte chunks in registers
// between its sum of squares and its output (d <= 16384 in bfloat16; only a
// wider row reads its remainder a second time), and its own chunks of scale
// beside them.  The sum is a warp-shuffle reduction and one shared-memory
// step.  At (4000, 4096) bf16 it runs as fast as a copy of the same bytes.
// scale is loaded first and x after it, so that the two device memory round
// trips overlap.  With programmatic dependent launch (pdl) the scale
// prologue may run while the previous kernel on the stream finishes:
// griddepcontrol.wait comes after it and before the first read of x (and
// the first write of y), so pdl is only for a scale that no kernel just
// before this one writes (a weight).  rsqrtf is the hardware's approximate
// reciprocal square root (within 2 ulp), so the result agrees with the
// plain version within float32 rounding, not bit for bit.
//
// Backward (rmsnorm_bwd_*): with r = rsqrt(mean(x^2) + eps), x^ = x r and
// g = dy * scale,
//   dx = r (g - x^ mean(g x^))            in x's type,
//   dscale = sum over rows of dy x^       in float32, cast to scale's type,
// where mean(g x^) = r sum(g x) / d, so that one float2 reduction a row
// (sum x^2, sum g x) gives both.  The reference has no backward kernel (it
// differentiates its jnp norm); the port's forward is this kernel, so its
// gradient is one too.  Bound: bytes, x and dy read once and dx written
// once: 100.7 MB at (4096, 4096) bfloat16, 0.030 ms at 3.35 TB/s.  Design:
// a persistent grid (kBwdMinCtas CTAs an SM, fewer where the ring does not
// fit), each CTA a contiguous run of rows, with the next steps' rows of x
// and dy in flight into a ring of shared memory (1-D bulk copies on an
// mbarrier) while the current step is reduced and dx written; a row goes to
// a group of warps chosen from d, so that narrow rows fill the CTA with
// several rows a step.  Each thread keeps dscale's partial for its columns
// in registers; at the end, after a grid-wide barrier (the launch is
// cooperative), every CTA sums a slice of the columns over the CTAs'
// float32 partials in a fixed order, in the same launch.  No float atomics,
// so two launches give the same bits; no PDL (the scale changes between
// training steps).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;        // a CTA a row
constexpr int kChunks = 8;           // 16-byte chunks a thread keeps

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

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack { T v[VEC]; };

template <typename TX, int VEC>
__device__ __forceinline__ float sum_squares(const Pack<TX, VEC>& p,
                                             float ss) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float f = to_f(p.v[i]);
    ss = __fmaf_rn(f, f, ss);
  }
  return ss;
}

template <typename TX, typename TS, int VEC>
__device__ __forceinline__ Pack<TX, VEC> normed(const Pack<TX, VEC>& p,
                                                const Pack<TS, VEC>& s,
                                                float r) {
  Pack<TX, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    o.v[i] = from_f<TX>(to_f(p.v[i]) * r * to_f(s.v[i]));
  return o;
}

template <typename TS, int VEC>
__device__ __forceinline__ Pack<TS, VEC> scale_chunk(const TS* scale, int c) {
  return reinterpret_cast<const Pack<TS, VEC>*>(scale)[c];
}

// A thread's scale chunks are its own (the same columns as its x chunks), so
// they go straight to registers, loaded before griddepcontrol.wait.
template <typename TX, typename TS, int VEC, int NC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ out, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  using P = Pack<TX, VEC>;
  using S = Pack<TS, VEC>;
  const long long row = blockIdx.x;
  const int chunks = d / VEC;
  S sc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = threadIdx.x + kThreads * k;
    if (c < chunks) sc[k] = scale_chunk<TS, VEC>(scale, c);
  }
  griddep_wait();
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  P cur[NC];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = threadIdx.x + kThreads * k;
    if (c < chunks) cur[k] = xr[c];
  }
#pragma unroll
  for (int k = 0; k < NC; ++k)
    if (threadIdx.x + kThreads * k < chunks) ss = sum_squares(cur[k], ss);
  // a row wider than the registers hold: its remainder is read twice
  for (int c = threadIdx.x + kThreads * NC; c < chunks; c += kThreads)
    ss = sum_squares(xr[c], ss);
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? partial[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) total = v;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(d) + eps);
  P* orow = reinterpret_cast<P*>(out + row * d);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = threadIdx.x + kThreads * k;
    if (c < chunks) orow[c] = normed<TX, TS, VEC>(cur[k], sc[k], r);
  }
  for (int c = threadIdx.x + kThreads * NC; c < chunks; c += kThreads)
    orow[c] = normed<TX, TS, VEC>(xr[c], scale_chunk<TS, VEC>(scale, c), r);
}

template <typename TX, typename TS, int VEC, int NC>
int launch_rows(const TX* x, const TS* sc, TX* out, long long rows, int d,
                float eps, int pdl, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, rmsnorm_kernel<TX, TS, VEC, NC>, x, sc, out, d, eps));
}

// Chunks a thread keeps: the row's chunks over the CTA, rounded up to a
// power of two, at most kChunks.
template <typename TX, typename TS, int VEC>
int launch_vec(const TX* x, const TS* sc, TX* out, long long rows, int d,
               float eps, int pdl, cudaStream_t s) {
  const int need = (d / VEC + kThreads - 1) / kThreads;
  if (need <= 1) return launch_rows<TX, TS, VEC, 1>(x, sc, out, rows, d, eps, pdl, s);
  if (need <= 2) return launch_rows<TX, TS, VEC, 2>(x, sc, out, rows, d, eps, pdl, s);
  if (need <= 4) return launch_rows<TX, TS, VEC, 4>(x, sc, out, rows, d, eps, pdl, s);
  return launch_rows<TX, TS, VEC, kChunks>(x, sc, out, rows, d, eps, pdl, s);
}

// vectorized: the wrapper found x, out and scale 16-byte aligned and d a
// multiple of 16 bytes of x; else every element is a chunk of its own.
template <typename TX, typename TS>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           float eps, int vectorized, int pdl, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  constexpr int kVec = 16 / sizeof(TX);
  const auto* xp = static_cast<const TX*>(x);
  const auto* sp = static_cast<const TS*>(scale);
  auto* op = static_cast<TX*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int status = vectorized
      ? launch_vec<TX, TS, kVec>(xp, sp, op, rows, d, eps, pdl, s)
      : launch_vec<TX, TS, 1>(xp, sp, op, rows, d, eps, pdl, s);
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}

// --- backward ------------------------------------------------------------
// Tunables: a thread's chunks of a row at most (its dscale partial stays in
// registers), CTAs an SM that __launch_bounds__ leaves registers for, the
// shared-memory header (the ring's mbarriers, the reduction's float2s) and
// the least body (the column sums' chunk sums).  kernels/rmsnorm.py's
// bwd_plan mirrors them and bwd_smem.
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxChunks = 8;
constexpr int kBwdMinCtas = 2;
constexpr int kBwdMaxStages = 8;
constexpr int kBwdHeader = 256;
constexpr int kBwdColSmem = 1024;
constexpr long long kBwdAlign = 128;

__host__ __device__ constexpr long long align_up(long long v) {
  return (v + kBwdAlign - 1) / kBwdAlign * kBwdAlign;
}

// shared memory, in bytes from the base: the header, scale (d of TS), then
// the body: the ring (stages x (x rows, dy rows) of a step) or, at the end,
// the step's groups' dscale partials (rows_per_step x d floats) and then
// the column sums' chunk sums, whichever is largest; stages is 0 where rows
// are read from device memory
struct BwdSmem {
  long long body, stage, total;
};
__host__ __device__ inline BwdSmem bwd_smem(int d, int rows_per_step,
                                            int stages, int sx, int ss) {
  BwdSmem m;
  m.body = kBwdHeader + align_up(static_cast<long long>(d) * ss);
  m.stage = align_up(static_cast<long long>(rows_per_step) * d * sx);
  const long long ring = 2LL * stages * m.stage;
  const long long combine = align_up(4LL * rows_per_step * d);
  const long long most = ring > combine ? ring : combine;
  m.total = m.body + (most > kBwdColSmem ? most : kBwdColSmem);
  return m;
}

// sum over m in [m0, m1), in order, of p[m * d + col], 16 loads in flight;
// read from L2 (other CTAs wrote them)
__device__ __forceinline__ float sum_column(const float* p, int m0, int m1,
                                            int d, int col) {
  float s = 0.0f;
  for (int m = m0; m < m1; m += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      v[u] = m + u < m1 ? __ldcg(p + static_cast<long long>(m + u) * d + col)
                        : 0.0f;
#pragma unroll
    for (int u = 0; u < 16; ++u) s += v[u];
  }
  return s;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A persistent CTA takes the rows [blockIdx.x * per, + per), a step of
// `groups` rows at a time, each row to a group of `warps` warps.  Vectorized
// (VEC > 1), thread 0 keeps the next stages - 1 steps' x and dy rows in
// flight into a ring of shared memory (two bulk copies a step: the rows are
// contiguous) while the CTA works on the current one; else the rows are
// read from device memory.  A thread reads its chunks twice: for the
// float2 (sum x^2, sum g x) of its row, reduced by shuffles and one
// shared-memory step, and for dx; its dscale partial (dy x^ of its columns
// over the run) stays in registers.  At the end the groups' partials are
// summed in order into partial[blockIdx.x]; after a grid-wide barrier (a
// ticket counter: the launch is cooperative, so every CTA is resident) each
// CTA sums a slice of dscale's columns over all the partials through a fixed
// two-level tree: chunks of at most 16 consecutive CTAs (bwd_plan), then the
// chunks in order.  The counter only orders the CTAs; the order of the
// additions is fixed, so two launches give the same bits.
template <typename TX, typename TS, int VEC, int NC>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinCtas)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   const TX* __restrict__ dy, TX* __restrict__ dx,
                   float* __restrict__ partial, int* __restrict__ tickets,
                   TS* __restrict__ dscale, long long rows, long long per,
                   int d, float eps, int warps, int stages, int cols,
                   int col_width, int col_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  using P = Pack<TX, VEC>;
  using S = Pack<TS, VEC>;
  constexpr bool kStaged = VEC > 1;
  const int chunks = d / VEC;
  const int width = 32 * warps;                 // threads of a row
  const int groups = kBwdWarps / warps;         // rows of a step
  const int group = threadIdx.x / width;
  const int lane = threadIdx.x % width;
  const int warp = threadIdx.x >> 5;
  const BwdSmem lay = bwd_smem(d, groups, kStaged ? stages : 0,
                               sizeof(TX), sizeof(TS));
  const uint32_t bars = smem_u32(smem);
  float2* red = reinterpret_cast<float2*>(smem + 64);     // [2][kBwdWarps]
  S* sc = reinterpret_cast<S*>(smem + kBwdHeader);
  unsigned char* body = smem + lay.body;
  const long long r0 = blockIdx.x * per;
  const long long r1 = min(rows, r0 + per);
  const int steps = static_cast<int>((r1 - r0 + groups - 1) / groups);

  // thread 0: step t's rows of x and dy into stage t % stages
  auto issue = [&](int t) {
    const int st = t % stages;
    const long long row = r0 + static_cast<long long>(t) * groups;
    const uint32_t bytes = static_cast<uint32_t>(
        min(static_cast<long long>(groups), r1 - row) * d * sizeof(TX));
    mbar_expect_tx(bars + 8 * st, 2 * bytes);
    bulk_load(smem_u32(body + 2 * st * lay.stage), x + row * d, bytes,
              bars + 8 * st);
    bulk_load(smem_u32(body + (2 * st + 1) * lay.stage), dy + row * d, bytes,
              bars + 8 * st);
  };
  if (kStaged && threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(stages, steps); ++t) issue(t);
  }
  for (int c = threadIdx.x; c < chunks; c += kBwdThreads)
    sc[c] = reinterpret_cast<const S*>(scale)[c];
  __syncthreads();

  float acc[NC][VEC];
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;

  for (int t = 0; t < steps; ++t) {
    const long long row = r0 + static_cast<long long>(t) * groups + group;
    const bool live = row < r1;
    const P* xs;
    const P* gs;
    if constexpr (kStaged) {
      const int st = t % stages;
      mbar_wait(bars + 8 * st, (t / stages) & 1);
      xs = reinterpret_cast<const P*>(body + 2 * st * lay.stage) +
           group * chunks;
      gs = reinterpret_cast<const P*>(body + (2 * st + 1) * lay.stage) +
           group * chunks;
    } else {
      xs = reinterpret_cast<const P*>(x + row * d);
      gs = reinterpret_cast<const P*>(dy + row * d);
    }
    float ss = 0.0f, gx = 0.0f;                 // sum x^2, sum (dy scale) x
    if (live) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = lane + width * k;
        if (c < chunks) {
          const P xv = xs[c], gv = gs[c];
          const S sv = sc[c];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float xf = to_f(xv.v[i]);
            ss = __fmaf_rn(xf, xf, ss);
            gx = __fmaf_rn(to_f(gv.v[i]) * to_f(sv.v[i]), xf, gx);
          }
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    float2* rb = red + (t & 1) * kBwdWarps;     // two buffers: no WAR barrier
    if ((threadIdx.x & 31) == 0) rb[warp] = make_float2(ss, gx);
    __syncthreads();
    // every thread is past step t - 1: its stage takes step t - 1 + stages
    if (kStaged && threadIdx.x == 0 && t >= 1 && t - 1 + stages < steps)
      issue(t - 1 + stages);
    if (!live) continue;
    float tss = 0.0f, tgx = 0.0f;
    for (int w = 0; w < warps; ++w) {
      const float2 v = rb[group * warps + w];
      tss += v.x;
      tgx += v.y;
    }
    const float r = rsqrtf(tss / static_cast<float>(d) + eps);
    const float mean = r * tgx / static_cast<float>(d);   // mean(g x^)
    P* orow = reinterpret_cast<P*>(dx + row * d);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + width * k;
      if (c < chunks) {
        const P xv = xs[c], gv = gs[c];         // read again
        const S sv = sc[c];
        P o;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xh = to_f(xv.v[i]) * r;
          const float gy = to_f(gv.v[i]);
          o.v[i] = from_f<TX>(r * (gy * to_f(sv.v[i]) - xh * mean));
          acc[k][i] = __fmaf_rn(gy, xh, acc[k][i]);
        }
        orow[c] = o;
      }
    }
  }

  // the CTA's partial: its groups' sums, in group order, through the body
  float* comb = reinterpret_cast<float*>(body);
  __syncthreads();                              // the ring's reads are done
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + width * k;
    if (c < chunks) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) comb[group * d + c * VEC + i] = acc[k][i];
    }
  }
  __syncthreads();
  float* mine = partial + blockIdx.x * static_cast<long long>(d);
  for (int j = threadIdx.x; j < d; j += kBwdThreads) {
    float s = comb[j];
    for (int g = 1; g < groups; ++g) s += comb[g * d + j];
    mine[j] = s;
  }

  // every CTA's partial is written before any CTA reads one: the grid is
  // co-resident (a cooperative launch) and tickets[0] counts the arrivals
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(tickets, 1);
    const long long t0 = clock64();
    while (ld_acquire(tickets) < static_cast<int>(gridDim.x)) {
      if (clock64() - t0 > kWaitLimit) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  // this CTA's columns [blockIdx.x cols, + cols), col_width at a time:
  // thread t sums column t % col_width over chunk t / col_width of the
  // CTAs' partials (a run of consecutive CTAs, in order), then the chunks'
  // sums are added in chunk order
  float* csum = reinterpret_cast<float*>(body);  // [col_chunks][col_width]
  const int ctas = gridDim.x;
  const int per_chunk = (ctas + col_chunks - 1) / col_chunks;
  const int cw = threadIdx.x % col_width, q = threadIdx.x / col_width;
  const int c_end = min(d, (blockIdx.x + 1) * cols);
  for (int c0 = blockIdx.x * cols; c0 < c_end; c0 += col_width) {
    const int col = c0 + cw;
    if (q < col_chunks) {
      const int m0 = q * per_chunk;
      csum[q * col_width + cw] =
          col < c_end ? sum_column(partial, m0, min(ctas, m0 + per_chunk), d,
                                   col)
                      : 0.0f;
    }
    __syncthreads();
    if (q == 0 && col < c_end) {
      float s = csum[cw];
      for (int k = 1; k < col_chunks; ++k) s += csum[k * col_width + cw];
      dscale[col] = from_f<TS>(s);
    }
    __syncthreads();
  }
  // the last CTA past the barrier sets the tickets back to 0 for the next
  // launch
  if (threadIdx.x == 0 && atomicAdd(tickets + 1, 1) == ctas - 1) {
    tickets[0] = 0;
    tickets[1] = 0;
  }
}

template <typename TX, typename TS, int VEC, int NC>
int launch_bwd_rows(const TX* x, const TS* sc, const TX* dy, TX* dx,
                    float* partial, int* tickets, TS* dscale, long long rows,
                    long long per, int d, float eps, int ctas, int warps,
                    int stages, int cols, int col_width, int col_chunks,
                    int smem, cudaStream_t s) {
  auto kernel = rmsnorm_bwd_kernel<TX, TS, VEC, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr;              // every CTA resident: the barrier
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, sc, dy, dx, partial, tickets,
                           dscale, rows, per, d, eps, warps, stages, cols,
                           col_width, col_chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the chunks a thread keeps: its share of the row, rounded up to a power of
// two, at most kBwdMaxChunks
template <typename TX, typename TS, int VEC>
int launch_bwd_vec(const TX* x, const TS* sc, const TX* dy, TX* dx,
                   float* partial, int* tickets, TS* dscale, long long rows,
                   long long per, int d, float eps, int ctas, int warps,
                   int stages, int cols, int col_width, int col_chunks,
                   int smem, cudaStream_t s) {
  const int need = (d / VEC + 32 * warps - 1) / (32 * warps);
#define RMSNORM_BWD_ROWS(NC)                                                  \
  launch_bwd_rows<TX, TS, VEC, NC>(x, sc, dy, dx, partial, tickets, dscale,  \
                                   rows, per, d, eps, ctas, warps, stages,   \
                                   cols, col_width, col_chunks, smem, s)
  if (need <= 1) return RMSNORM_BWD_ROWS(1);
  if (need <= 2) return RMSNORM_BWD_ROWS(2);
  if (need <= 4) return RMSNORM_BWD_ROWS(4);
  return RMSNORM_BWD_ROWS(kBwdMaxChunks);
#undef RMSNORM_BWD_ROWS
}

// The plan (kernels/rmsnorm.py, bwd_plan): ctas CTAs of `per` rows, `warps`
// warps a row, `stages` ring stages, `smem` bytes of dynamic shared memory;
// dscale's columns `cols` a CTA, summed col_width at a time over
// col_chunks runs of CTAs.  partial holds ctas x d floats, tickets 2 ints
// that are 0.
// Refuses a plan the kernel cannot run.
template <typename TX, typename TS>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* partial, void* tickets, void* dscale, long long rows,
               int d, float eps, int vectorized, int ctas, long long per,
               int warps, int stages, int cols, int col_width, int col_chunks,
               int smem, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  constexpr int kVec = 16 / sizeof(TX);
  const int vec = vectorized ? kVec : 1;
  const int need = (d / vec + 32 * warps - 1) / (32 * warps);
  if ((warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      need > kBwdMaxChunks || ctas <= 0 || per <= 0 ||
      (vectorized && (d % kVec || stages < 2 || stages > kBwdMaxStages)) ||
      (ctas - 1) * per >= rows || ctas * per < rows ||
      static_cast<long long>(cols) * ctas < d || col_width <= 0 ||
      col_chunks <= 0 || col_width * col_chunks > kBwdThreads ||
      bwd_smem(d, kBwdWarps / warps, vectorized ? stages : 0, sizeof(TX),
               sizeof(TS)).total > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const TX*>(x);
  const auto* sp = static_cast<const TS*>(scale);
  const auto* gp = static_cast<const TX*>(dy);
  auto* op = static_cast<TX*>(dx);
  auto* pp = static_cast<float*>(partial);
  auto* tp = static_cast<int*>(tickets);
  auto* dp = static_cast<TS*>(dscale);
  auto s = static_cast<cudaStream_t>(stream);
  return vectorized
      ? launch_bwd_vec<TX, TS, kVec>(xp, sp, gp, op, pp, tp, dp, rows, per, d,
                                     eps, ctas, warps, stages, cols,
                                     col_width, col_chunks, smem, s)
      : launch_bwd_vec<TX, TS, 1>(xp, sp, gp, op, pp, tp, dp, rows, per, d,
                                  eps, ctas, warps, stages, cols, col_width,
                                  col_chunks, smem, s);
}

}  // namespace

#define RMSNORM_BWD_ENTRY(NAME, TX, TS)                                       \
  extern "C" int NAME(const void* x, const void* scale, const void* dy,      \
                      void* dx, void* partial, void* tickets, void* dscale,  \
                      long long rows, int d, float eps, int vectorized,      \
                      int ctas, long long per, int warps, int stages,        \
                      int cols, int col_width, int col_chunks, int smem,     \
                      void* stream) {                                        \
    return launch_bwd<TX, TS>(x, scale, dy, dx, partial, tickets, dscale,    \
                              rows, d, eps, vectorized, ctas, per, warps,    \
                              stages, cols, col_width, col_chunks, smem,     \
                              stream);                                       \
  }

RMSNORM_BWD_ENTRY(rmsnorm_bwd_f32_f32, float, float)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_f32_bf16, float, __nv_bfloat16)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_bf16_f32, __nv_bfloat16, float)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#define RMSNORM_ENTRY(NAME, TX, TS)                                           \
  extern "C" int NAME(const void* x, const void* scale, void* out,           \
                      long long rows, int d, float eps, int vectorized,      \
                      int pdl, void* stream) {                               \
    return launch<TX, TS>(x, scale, out, rows, d, eps, vectorized, pdl,      \
                          stream);                                           \
  }

RMSNORM_ENTRY(rmsnorm_f32_f32, float, float)
RMSNORM_ENTRY(rmsnorm_f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRY(rmsnorm_bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRY(rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
