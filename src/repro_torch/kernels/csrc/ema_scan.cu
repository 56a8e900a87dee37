// First-order EMA filter out_t = alpha*x_t + (1-alpha)*out_{t-1}.
// Hand-written for Hopper (sm_90a).  Two entries:
//
//   ema_scan_f32    one float32 trace per row, seeded with out_{-1} = x_0
//                   (ops.ema_scan, spikes.ema_filter(backend="cuda"));
//   ema_blocks_f64  the profiling engine's blocked float64 EMA: rows of
//                   fixed-position 256-sample blocks, each block evaluated
//                   exactly as the reference's _ema_filter_block (prefix
//                   doubling) with the filter state carried between blocks;
//                   ragged rows and a carried state per row in one launch.
//
// Replaces: repro/kernels/ema_scan.py, ema_scan_pallas (_ema_kernel), the
// TPU kernel that walks 128-sample rows in order with a 128x128 decay-matrix
// matmul per row and the carry in SMEM.
//
// Bound: bytes.  ema_scan_f32 moves 8 B a sample and costs three float
// operations; ema_blocks_f64 moves 16 B a sample (8 read, 8 written) and
// costs ~18 float64 operations (a multiply, and a multiply and an add for
// each of the eight doubling steps) -- both far below the card's operation
// rates.  A trace is a chain of dependent steps, so small calls are bound
// by latency, not by either rate.
//
// ema_scan_f32: one warp per row.  Lane l owns a contiguous segment of n/32
// samples.  Pass 1 scans the segment from a zero state and keeps the affine
// map it applies to an incoming state, (w^len, local end value).  A 5-step
// shuffle scan composes the lanes' maps, which gives every lane its incoming
// state; pass 2 re-scans the segment from that state and writes it out.
//
// ema_blocks_f64: one warp per row, the row's 256-sample block in registers
// strided over the lanes (register r of lane l holds sample 32r + l, so a
// load or store of one register is one coalesced 256-byte access).  A
// doubling step of shift s < 32 reads the value s places back with one
// shuffle per register: lanes l >= s take register r of lane l - s, lanes
// l < s register r - 1 of lane l - s + 32.  Shifts 32, 64 and 128 are moves
// between a lane's own registers.  Every step walks the registers from the
// top down, so each reads the values from before the step, and holds two
// shuffled values at a time: few live registers keep many warps, and so
// many loads, in flight on an SM.  The next block's loads are
// issued before the current block's steps; the carry is the block's last
// value, broadcast from lane 31.  Rows past their length are neither read
// (zeros stand in) nor written: a doubling step only adds earlier positions
// into later ones, so the padding never reaches a real sample.
//
// All arithmetic uses __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn), so the
// compiler never contracts a multiply and an add into an FMA: the float64
// entry is bit-identical to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void ema_scan_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long rows,
                                long long n, float alpha, float w) {
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
    const float dp = __shfl_up_sync(kFull, d, off);
    const float hp = __shfl_up_sync(kFull, h, off);
    if (lane >= off) {
      h = __fadd_rn(__fmul_rn(d, hp), h);
      d = __fmul_rn(dp, d);
    }
  }
  const float seed = xr[0];
  const float d_in = __shfl_up_sync(kFull, d, 1);
  const float h_in = __shfl_up_sync(kFull, h, 1);
  float state = lane == 0 ? seed : __fadd_rn(__fmul_rn(d_in, seed), h_in);
  for (long long t = b; t < e; ++t) {
    state = __fadd_rn(__fmul_rn(w, state), __fmul_rn(alpha, xr[t]));
    orow[t] = state;
  }
}

constexpr int kBlock = 256;                // EMA_BLOCK
constexpr int kRegs = kBlock / 32;         // samples a lane holds
constexpr int kWarps = 4;                  // rows a CTA
constexpr int kSteps = 8;                  // doubling steps: shift 1 .. 128
constexpr int kInlineRows = 255;           // ragged rows whose bounds ride
                                           // in the launch's parameters

struct Rows {
  const double* x;
  double* out;
  const long long* offsets;  // ragged: rows + 1 bounds into x and out
  long long rows;
  long long n;               // uniform rows: n samples each, row r at
  long long x_stride;        // x + r*x_stride and out + r*n
  const double* state;       // carried filter value, read at slot
  const unsigned char* has;  // whether the slot has one (null: has_all)
  int has_all;
  const long long* index;    // slot of each row (null: the row itself)
  double* state_out;         // a row's last value, written at its slot
  unsigned char* has_out;    // (both null: not written)
  double alpha;
  double w;
};

// the bounds of up to kInlineRows ragged rows, passed by value (2,048 B of
// kernel parameters): a snapshot's rows need no copy to the card first
struct Bounds {
  long long v[kInlineRows + 1];
};

__device__ __forceinline__ void load_block(const double* xr, long long base,
                                           long long len, int lane,
                                           double (&v)[kRegs]) {
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const long long i = base + r * 32 + lane;
    v[r] = i < len ? xr[i] : 0.0;
  }
}

// one row, one warp: len samples at xr, filtered into orow
__device__ __forceinline__ void filter_row(const Rows& a, long long row,
                                           const double* xr, double* orow,
                                           long long len) {
  const int lane = threadIdx.x & 31;
  const long long slot = a.index != nullptr ? a.index[row] : row;
  bool has = a.has != nullptr ? a.has[slot] != 0 : a.has_all != 0;
  double state = has ? a.state[slot] : 0.0;
  const long long nblk = (len + kBlock - 1) / kBlock;
  double o[kRegs];
  if (nblk > 0) load_block(xr, 0, len, lane, o);
  for (long long b = 0; b < nblk; ++b) {
    const long long base = b * kBlock;
    double nxt[kRegs];
    if (b + 1 < nblk) load_block(xr, base + kBlock, len, lane, nxt);

    const double p0 = o[0];
#pragma unroll
    for (int r = 0; r < kRegs; ++r) o[r] = __dmul_rn(o[r], a.alpha);
    if (lane == 0) {                       // the seed, at position 0
      o[0] = has ? __dadd_rn(o[0], __dmul_rn(state, a.w)) : p0;
    }
    // the host's decays w, w^2, w^4, ... squared in float64; the steps stop
    // at the first that is 0.0, as the reference's `decay != 0.0` does
    double d = a.w;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (d == 0.0) break;
      if (k < 5) {                         // shifts 1 .. 16: shuffles, the
        const int s = 1 << k;              // registers from the top down
        const bool own = lane >= s;
        double hi = __shfl_sync(kFull, o[kRegs - 1], (lane - s) & 31);
#pragma unroll
        for (int r = kRegs - 1; r > 0; --r) {
          const double lo = __shfl_sync(kFull, o[r - 1], (lane - s) & 31);
          o[r] = __dadd_rn(o[r], __dmul_rn(own ? hi : lo, d));
          hi = lo;
        }
        if (own) o[0] = __dadd_rn(o[0], __dmul_rn(hi, d));
      } else {                             // shifts 32, 64, 128: registers
        const int q = 1 << (k - 5);
#pragma unroll
        for (int r = kRegs - 1; r >= q; --r)
          o[r] = __dadd_rn(o[r], __dmul_rn(o[r - q], d));
      }
      d = __dmul_rn(d, d);
    }

    // the lane that holds the row's last sample writes the row's state;
    // no register is picked by a run-time index, which would put the block
    // in local memory
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const long long i = base + r * 32 + lane;
      if (i < len) {
        orow[i] = o[r];
        if (i == len - 1 && a.state_out != nullptr) {
          a.state_out[slot] = o[r];
          a.has_out[slot] = 1;
        }
      }
    }
    if (b + 1 < nblk) {                    // a full block: carry its last
      state = __shfl_sync(kFull, o[kRegs - 1], 31);
      has = true;
#pragma unroll
      for (int r = 0; r < kRegs; ++r) o[r] = nxt[r];
    }
  }
}

__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

__global__ void __launch_bounds__(kWarps * 32)
ema_blocks_uniform_kernel(const __grid_constant__ Rows a) {
  const long long row = warp_row();
  if (row >= a.rows) return;               // whole warps exit together
  filter_row(a, row, a.x + row * a.x_stride, a.out + row * a.n, a.n);
}

__global__ void __launch_bounds__(kWarps * 32)
ema_blocks_ragged_kernel(const __grid_constant__ Rows a) {
  const long long row = warp_row();
  if (row >= a.rows) return;
  const long long begin = a.offsets[row];
  filter_row(a, row, a.x + begin, a.out + begin, a.offsets[row + 1] - begin);
}

__global__ void __launch_bounds__(kWarps * 32)
ema_blocks_inline_kernel(const __grid_constant__ Rows a,
                         const __grid_constant__ Bounds b) {
  const long long row = warp_row();
  if (row >= a.rows) return;
  const long long begin = b.v[row];
  filter_row(a, row, a.x + begin, a.out + begin, b.v[row + 1] - begin);
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

// Ragged rows come as rows + 1 bounds: on the host (host_offsets, at most
// kInlineRows rows: passed in the launch) or on the card (offsets).
extern "C" int ema_blocks_f64(const void* x, void* out,
                              const void* host_offsets, const void* offsets,
                              long long rows, long long n, long long x_stride,
                              const void* state, const void* has, int has_all,
                              const void* index, void* state_out,
                              void* has_out, double alpha, double w,
                              void* stream) {
  if (rows <= 0) return 0;
  if (host_offsets != nullptr && rows > kInlineRows)
    return static_cast<int>(cudaErrorInvalidValue);
  Rows a;
  a.x = static_cast<const double*>(x);
  a.out = static_cast<double*>(out);
  a.offsets = static_cast<const long long*>(offsets);
  a.rows = rows;
  a.n = n;
  a.x_stride = x_stride;
  a.state = static_cast<const double*>(state);
  a.has = static_cast<const unsigned char*>(has);
  a.has_all = has_all;
  a.index = static_cast<const long long*>(index);
  a.state_out = static_cast<double*>(state_out);
  a.has_out = static_cast<unsigned char*>(has_out);
  a.alpha = alpha;
  a.w = w;
  const unsigned ctas = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (host_offsets != nullptr) {
    Bounds b;
    const long long* h = static_cast<const long long*>(host_offsets);
    for (long long i = 0; i <= rows; ++i) b.v[i] = h[i];
    ema_blocks_inline_kernel<<<ctas, kWarps * 32, 0, st>>>(a, b);
  } else if (offsets != nullptr) {
    ema_blocks_ragged_kernel<<<ctas, kWarps * 32, 0, st>>>(a);
  } else {
    ema_blocks_uniform_kernel<<<ctas, kWarps * 32, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
