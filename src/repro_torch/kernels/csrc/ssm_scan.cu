// Mamba-1 selective scan over a (b, s, di) sequence with a (di, ds) state
// per sequence, float32 inside:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t        (di, ds)
//   y_t = sum_n C_t[n] * h_t[:, n]  (+ D * x_t when D is given)
// x and y are float32 or bfloat16 (y in x's type), dt float32 or bfloat16;
// A (di, ds), B and C (b, s, ds), D (di,), h0 and h_last (b, di, ds) are
// float32.  h0 may be null (zero state) and may be the same buffer as
// h_last (each state element is read and written by one thread).
// Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssm_scan.py, ssm_scan_pallas (_ssm_kernel), the
// TPU kernel that carries a (ds, 256) state tile in VMEM across a
// sequential grid axis of 64-step sequence blocks.
//
// Bound: operations, on the special-function units.  Every (t, channel,
// state) needs one exp (537 M at b=4, s=1024, di=8192, ds=16): at 16 exp a
// clock per SM, 132 SMs and 1,980 MHz that is 0.128 ms, against 0.081 ms
// to move the 270 MB of x and y (bf16) and dt (float32) at 3.35 TB/s.
// expf (not __expf) is a few float32 instructions around the hardware's
// ex2, so the float32 pipes carry a comparable load.
//
// Design: the sequence loop runs inside one CTA, the state in registers.
// A group of LANES neighbouring threads owns one (sequence, channel); each
// thread holds four of its ds states and their row of A.  A CTA of 128
// threads covers 128 / LANES channels of one sequence, so b * di * LANES /
// 4 threads fill the card (131,072 at b=4, di=8192, ds=16).  For each block
// of 16 time steps the CTA stages x and dt (as float32, coalesced along
// channels) and the B and C rows in shared memory, walks the 16 steps,
// reduces y over the LANES threads of a channel with xor-shuffles, and
// writes the block's y back coalesced.  Multiplies and adds are
// __fmul_rn/__fadd_rn, so nothing is contracted into an FMA: the float32
// result differs from the plain version only in the order of the sum over
// states and in the last bit of an exp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStates = 4;       // states per thread
constexpr int kSteps = 16;       // time steps staged per pass

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

template <typename TX, typename TD, int LANES>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ D,
                const float* h0, TX* __restrict__ y, float* h_last, int s,
                int di, int ds) {
  constexpr int CH = kThreads / LANES;            // channels per CTA
  constexpr int NS = kStates * LANES;             // states per channel
  __shared__ float sx[kSteps][CH];
  __shared__ float sdt[kSteps][CH];
  __shared__ float sy[kSteps][CH];
  __shared__ float sbc[kSteps][2 * NS];           // B row, then C row

  const long long seq = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int lane = threadIdx.x % LANES;
  const int cl = threadIdx.x / LANES;
  const int ch = c0 + cl;
  const bool live = ch < di;
  const int n0 = lane * kStates;
  const long long hrow = (seq * di + ch) * ds;

  float a[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const bool ok = live && n0 + k < ds;
    a[k] = ok ? A[static_cast<long long>(ch) * ds + n0 + k] : 0.0f;
    h[k] = ok && h0 != nullptr ? h0[hrow + n0 + k] : 0.0f;
  }
  const float d_skip = live && D != nullptr ? D[ch] : 0.0f;

  for (int t0 = 0; t0 < s; t0 += kSteps) {
    const int nt = min(kSteps, s - t0);
    const long long row0 = seq * s + t0;          // row of (seq, t0)
    for (int e = threadIdx.x; e < kSteps * CH; e += kThreads) {
      const int st = e / CH, cc = e % CH;
      float xv = 0.0f, dv = 0.0f;
      if (st < nt && c0 + cc < di) {
        const long long off = (row0 + st) * di + c0 + cc;
        xv = to_f(x[off]);
        dv = to_f(dt[off]);
      }
      sx[st][cc] = xv;
      sdt[st][cc] = dv;
    }
    for (int e = threadIdx.x; e < kSteps * 2 * NS; e += kThreads) {
      const int st = e / (2 * NS), j = e % (2 * NS);
      float v = 0.0f;
      if (st < nt) {
        if (j < ds)
          v = B[(row0 + st) * ds + j];
        else if (j >= NS && j - NS < ds)
          v = C[(row0 + st) * ds + j - NS];
      }
      sbc[st][j] = v;
    }
    __syncthreads();
    for (int st = 0; st < nt; ++st) {
      const float dtv = sdt[st][cl];
      const float xv = sx[st][cl];
      const float dtx = __fmul_rn(dtv, xv);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float decay = expf(__fmul_rn(dtv, a[k]));
        h[k] = __fadd_rn(__fmul_rn(decay, h[k]),
                         __fmul_rn(dtx, sbc[st][n0 + k]));
        acc = __fadd_rn(acc, __fmul_rn(sbc[st][NS + n0 + k], h[k]));
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      if (lane == 0)
        sy[st][cl] = D != nullptr ? __fadd_rn(acc, __fmul_rn(d_skip, xv))
                                  : acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kSteps * CH; e += kThreads) {
      const int st = e / CH, cc = e % CH;
      if (st < nt && c0 + cc < di)
        y[(row0 + st) * di + c0 + cc] = from_f<TX>(sy[st][cc]);
    }
  }
#pragma unroll
  for (int k = 0; k < kStates; ++k)
    if (live && n0 + k < ds) h_last[hrow + n0 + k] = h[k];
}

template <typename TX, typename TD, int LANES>
void launch_lanes(const void* x, const void* dt, const void* A,
                  const void* B, const void* C, const void* D,
                  const void* h0, void* y, void* h_last, int batch, int s,
                  int di, int ds, cudaStream_t stream) {
  constexpr int CH = kThreads / LANES;
  const dim3 grid((di + CH - 1) / CH, batch);
  ssm_scan_kernel<TX, TD, LANES><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<TX*>(y),
      static_cast<float*>(h_last), s, di, ds);
}

template <typename TX, typename TD>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y,
           void* h_last, int batch, int s, int di, int ds, void* stream) {
  if (batch <= 0 || di <= 0) return 0;
  if (ds <= 0 || ds > 32 * kStates)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define SSM_LAUNCH(LANES)                                                 \
  launch_lanes<TX, TD, LANES>(x, dt, A, B, C, D, h0, y, h_last, batch, s, \
                              di, ds, st)
  // the fewest lanes (a power of two) whose kStates each hold ds states
  if (ds <= kStates)
    SSM_LAUNCH(1);
  else if (ds <= 2 * kStates)
    SSM_LAUNCH(2);
  else if (ds <= 4 * kStates)
    SSM_LAUNCH(4);
  else if (ds <= 8 * kStates)
    SSM_LAUNCH(8);
  else if (ds <= 16 * kStates)
    SSM_LAUNCH(16);
  else
    SSM_LAUNCH(32);
#undef SSM_LAUNCH
  return static_cast<int>(cudaGetLastError());
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
