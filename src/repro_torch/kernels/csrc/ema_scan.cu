// First-order EMA filter out_t = alpha*x_t + (1-alpha)*out_{t-1}, seeded
// with out_{-1} = x_0, over each row of a (rows, n) float32 block.
// Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/ema_scan.py, ema_scan_pallas (_ema_kernel), the
// TPU kernel that walks 128-sample rows in order with a 128x128 decay-matrix
// matmul per row and the carry in SMEM.
//
// Bound: bytes.  The recurrence costs three float operations per sample and
// moves 8 B (4 B read, 4 B written), far below the card's operation rate;
// but one trace is a chain of dependent steps, so a naive one-thread scan is
// bound by latency, not by either rate.
//
// Design: one warp per row.  Lane l owns a contiguous segment of n/32
// samples.  Pass 1 scans the segment from a zero state and keeps the affine
// map it applies to an incoming state, (w^len, local end value).  A 5-step
// shuffle scan composes the lanes' maps, which gives every lane its incoming
// state; pass 2 re-scans the segment from that state and writes it out.  All
// arithmetic uses __fmul_rn/__fadd_rn, so the compiler never contracts a
// multiply and an add into an FMA.
#include <cuda_runtime.h>

namespace {

__global__ void ema_scan_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long rows,
                                long long n, float alpha, float w) {
  const unsigned full = 0xffffffffu;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;                // whole warps exit together
  const float* xr = x + warp * n;
  float* orow = out + warp * n;
  const long long seg = (n + 31) / 32;
  const long long b = lane * seg;
  const long long e = b + seg < n ? b + seg : n;

  float h = 0.0f, d = 1.0f;                // this segment's map: s -> d*s + h
  for (long long t = b; t < e; ++t) {
    h = __fadd_rn(__fmul_rn(w, h), __fmul_rn(alpha, xr[t]));
    d = __fmul_rn(d, w);
  }
  // inclusive scan of the maps: (earlier) then (this) composes to
  // (d_e*d_t, d_t*h_e + h_t)
  for (int off = 1; off < 32; off <<= 1) {
    const float dp = __shfl_up_sync(full, d, off);
    const float hp = __shfl_up_sync(full, h, off);
    if (lane >= off) {
      h = __fadd_rn(__fmul_rn(d, hp), h);
      d = __fmul_rn(dp, d);
    }
  }
  const float seed = xr[0];
  const float d_in = __shfl_up_sync(full, d, 1);
  const float h_in = __shfl_up_sync(full, h, 1);
  float state = lane == 0 ? seed : __fadd_rn(__fmul_rn(d_in, seed), h_in);
  for (long long t = b; t < e; ++t) {
    state = __fadd_rn(__fmul_rn(w, state), __fmul_rn(alpha, xr[t]));
    orow[t] = state;
  }
}

}  // namespace

extern "C" int ema_scan_f32(const void* x, void* out, long long rows,
                            long long n, float alpha, float w, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int threads = 128;                 // four rows per CTA
  const long long warps_per_cta = threads / 32;
  const long long ctas = (rows + warps_per_cta - 1) / warps_per_cta;
  ema_scan_kernel<<<static_cast<unsigned>(ctas), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, n, alpha,
      w);
  return static_cast<int>(cudaGetLastError());
}
