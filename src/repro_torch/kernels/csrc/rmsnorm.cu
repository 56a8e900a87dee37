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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

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
