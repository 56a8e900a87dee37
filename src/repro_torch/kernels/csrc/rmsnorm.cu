// RMSNorm over the rows of an (n, d) block:
//   y = x * rsqrt(mean(x^2) + eps) * scale, statistics in float32, cast to
// x's type.  x and y are float32 or bfloat16; scale is float32 or bfloat16.
// Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/rmsnorm.py, rmsnorm_pallas (_rmsnorm_kernel), the
// TPU kernel that normalises a 256-row tile per grid step in VMEM.
//
// Bound: bytes.  Each element is read once and written once (4 B + 4 B in
// bfloat16, plus the d-element scale), against three float operations per
// element; a (4096, 4096) bfloat16 block needs 20 us at 3.35 TB/s.
//
// Design: one CTA of 256 threads per row.  Pass 1 reads the row with
// 16-byte vector loads where the row allows them and sums squares in
// float32; a warp-shuffle reduction and one shared-memory step give the
// row's total.  Pass 2 reads the row again (it is still in L1/L2: a 4096-wide
// bfloat16 row is 8 KB) and writes the output.  rsqrtf is the hardware's
// approximate reciprocal square root (within 2 ulp), so the result agrees
// with the plain version within float32 rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ float block_sum(float v, float* shared) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? shared[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) shared[0] = v;
  }
  __syncthreads();
  return shared[0];
}

// VEC elements per access: 16 bytes when the wrapper found the rows aligned
// and d a multiple of it, else 1.
template <typename TX, typename TS, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ out, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  struct alignas(sizeof(TX) * VEC) Pack { TX v[VEC]; };
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* orow = out + row * d;
  const int chunks = d / VEC;
  float ss = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const Pack p = reinterpret_cast<const Pack*>(xr)[c];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float f = to_f(p.v[i]);
      ss += f * f;
    }
  }
  const float total = block_sum(ss, partial);
  const float r = rsqrtf(total / static_cast<float>(d) + eps);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const Pack p = reinterpret_cast<const Pack*>(xr)[c];
    Pack o;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o.v[i] = from_f<TX>(to_f(p.v[i]) * r * to_f(scale[c * VEC + i]));
    reinterpret_cast<Pack*>(orow)[c] = o;
  }
}

template <typename TX, typename TS>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           float eps, int vectorized, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  constexpr int kVec = 16 / sizeof(TX);
  const auto* xp = static_cast<const TX*>(x);
  const auto* sp = static_cast<const TS*>(scale);
  auto* op = static_cast<TX*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows);
  if (vectorized)
    rmsnorm_kernel<TX, TS, kVec><<<grid, kThreads, 0, s>>>(xp, sp, op, d, eps);
  else
    rmsnorm_kernel<TX, TS, 1><<<grid, kThreads, 0, s>>>(xp, sp, op, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RMSNORM_ENTRY(NAME, TX, TS)                                          \
  extern "C" int NAME(const void* x, const void* scale, void* out,          \
                      long long rows, int d, float eps, int vectorized,     \
                      void* stream) {                                       \
    return launch<TX, TS>(x, scale, out, rows, d, eps, vectorized, stream); \
  }

RMSNORM_ENTRY(rmsnorm_f32_f32, float, float)
RMSNORM_ENTRY(rmsnorm_f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRY(rmsnorm_bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRY(rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
