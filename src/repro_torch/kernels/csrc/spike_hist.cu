// Spike-magnitude histograms of many rows, for every tracked bin size in one
// launch.  Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/spike_hist.py, spike_hist_batch_pallas
// (_batch_hist_kernel) and spike_hist_pallas (_hist_kernel), the TPU
// kernels that bin relative power r into [lo, hi) with one launch per bin
// size.  Semantics per sample: v = r, or r / divisor (one IEEE divide, the
// divisor a scalar or one per row); counted only if v >= lo (-inf padding
// and NaN never count); bin = min((long long)((v - lo) / c), n - 1).  The
// subtract and the IEEE divide are separate operations in the value type T
// (double for the profiling engine and the builder, float for
// ops.spike_hist), and the quotient is truncated like NumPy's
// astype(int64), so the counts equal the reference's float64 scatter
// exactly.  Built without fast math: every divide is correctly rounded.
//
// Bound: bytes.  Each sample is read once (8 B in double) and costs one
// compare, one subtract and, per bin size, one divide and one shared-memory
// atomic.  At the fleet path's shape (10,000 x 256 doubles, six bin sizes)
// one launch reads 20.5 MB and writes 2.9 MB of int32 counts.
//
// Design: a group of warps owns a row (or a column range of a long row) and
// keeps the counters of ALL bin sizes of that row in shared memory (72 ints
// for the six default sizes), so the six histograms cost one pass over the
// samples.  The group is one warp (eight rows a CTA, each warp with its own
// counters: no contention between warps and no barrier between rows) unless
// the row is long and rows are few, or the counters do not fit eight times
// (then the CTA's eight warps share one set).  Each lane reads 16 bytes at a
// time (two doubles), four loads in flight.  The float64 divides are most
// of the arithmetic, so a size whose quotient is an exact power-of-two
// scaling of another's (fl(0.1) is exactly 2 fl(0.05)) or of r - lo (a
// size that is a power of two) takes it by a multiply, which gives the
// divide's bits (the plan and its proof: kernels/spike_hist.py,
// _quotient_plan): the six default sizes take two divides, not six.  The
// group then writes its counters once:
//  - counts: every counter is stored, zeros included, so the output needs
//    no clearing; a row split over several CTAs (col_splits > 1, one long
//    trace) instead adds its non-zero counters with integer atomics into an
//    output the wrapper cleared;
//  - accumulate (out_f64): the non-zero counters are added with float64
//    atomics into out[out_rows[row]] (or out[row]), so a repeated row index
//    adds up as index_add_ does, and integer counts below 2**53 stay exact.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxSizes = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // 16-byte loads in flight a lane

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack { T v[VEC]; };

struct Args {
  const void* r;
  long long rows, F;
  // per bin size, in the quotient plan's order (kernels/spike_hist.py,
  // _quotient_plan): size, first counter, last bin index, and the power of
  // two that scales the base or r - lo into a size that is not divided
  const double* sizes;
  const int* starts;
  const int* tops;
  const double* scales;
  int n_sizes;
  double lo;
  const void* divisor;        // null: none
  int divisor_per_row;        // 0: one scalar, 1: one a row
  void* out;
  int out_f64;                // 1: add into a float64 (out_n, total) block
  const long long* out_rows;  // null: row i adds into out[i]
  long long out_n;
  int total_bins;
  int group;                  // warps that share a row's counters: 1 or 8
  long long cols_per_cta;
  int atomic_int;             // int32 counts of a split row: atomics
};

// The quotient plan's kinds (kernels/spike_hist.py): a divide that sets the
// base, the base times a power of two, r - lo times a power of two.
constexpr int kDivide = 0, kFromBase = 1, kFromShifted = 2;
// The plan of the profiling engine's six sizes (0.05, 0.1, 0.2 | 0.15 |
// 0.25, 0.5): two divides, not six.
constexpr int kPlanSix = kDivide | kFromBase << 2 | kFromBase << 4 |
                         kDivide << 6 | kFromShifted << 8 | kFromShifted << 10;

// NS: the number of bin sizes and PLAN: their kinds, two bits a size, fixed
// at compile time for the plans the port uses (ops.spike_hist's one size;
// the engine's six sizes), so that each size's divisor, counters and scaling sit
// in registers and the size loop unrolls without a branch, and no quotient
// but the base lives across a divide (whose slow path is a call); NS = 0
// reads the sizes from shared memory at run time and divides by each.
template <typename T, int VEC, int NS, int PLAN>
__global__ void __launch_bounds__(kThreads) spike_hist_kernel(Args a) {
  extern __shared__ int counts[];          // (kWarps / group) counter sets
  __shared__ T s_size[kMaxSizes];
  __shared__ int s_start[kMaxSizes], s_top[kMaxSizes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sets = kWarps / a.group;
  const int set = warp / a.group, wig = warp % a.group;
  const int total = a.total_bins;
  int* my = counts + set * total;
  for (int i = threadIdx.x; i < sets * total; i += kThreads) counts[i] = 0;
  if (threadIdx.x < a.n_sizes) {
    s_size[threadIdx.x] = static_cast<T>(a.sizes[threadIdx.x]);
    s_start[threadIdx.x] = a.starts[threadIdx.x];
    s_top[threadIdx.x] = a.tops[threadIdx.x];
  }
  constexpr int kR = NS > 0 ? NS : 1;
  T sz[kR], scl[kR];
  int start[kR], top[kR];
#pragma unroll
  for (int b = 0; b < NS; ++b) {
    sz[b] = static_cast<T>(a.sizes[b]);
    scl[b] = static_cast<T>(a.scales[b]);   // a power of two: exact in T
    start[b] = a.starts[b];
    top[b] = a.tops[b];
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * sets + set;
  if (row >= a.rows) return;               // uniform over a group of 8
  const T* rr = static_cast<const T*>(a.r) + row * a.F;
  const T tlo = static_cast<T>(a.lo);
  const bool has_div = a.divisor != nullptr;
  const T div = has_div ? static_cast<const T*>(a.divisor)[
      a.divisor_per_row ? row : 0] : static_cast<T>(1);
  const int n_sizes = a.n_sizes;
  auto count = [&](T v) {
    if (has_div) v = v / div;
    if (v >= tlo) {
      const T shifted = v - tlo;
      if constexpr (NS > 0) {
        T base = shifted;
#pragma unroll
        for (int b = 0; b < NS; ++b) {
          const int kind = (PLAN >> (2 * b)) & 3;   // known at compile time
          T q;
          if (kind == kDivide) {
            q = shifted / sz[b];
            base = q;
          } else {
            q = (kind == kFromBase ? base : shifted) * scl[b];
          }
          long long bin = static_cast<long long>(q);   // C truncation
          if (bin > top[b]) bin = top[b];
          atomicAdd(&my[start[b] + static_cast<int>(bin)], 1);
        }
      } else {
        for (int b = 0; b < n_sizes; ++b) {
          const T q = shifted / s_size[b];
          long long bin = static_cast<long long>(q);   // C truncation
          if (bin > s_top[b]) bin = s_top[b];
          atomicAdd(&my[s_start[b] + static_cast<int>(bin)], 1);
        }
      }
    }
  };
  using P = Pack<T, VEC>;
  const long long c0 = static_cast<long long>(blockIdx.y) * a.cols_per_cta;
  const long long c1 = c0 + a.cols_per_cta < a.F ? c0 + a.cols_per_cta : a.F;
  const long long step = static_cast<long long>(a.group) * 32 * VEC;
  for (long long j = c0 + static_cast<long long>(wig * 32 + lane) * VEC;
       j < c1; j += kUnroll * step) {
    P p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * step < c1)
        p[u] = *reinterpret_cast<const P*>(rr + j + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * step < c1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) count(p[u].v[i]);
      }
  }
  if (a.group > 1) __syncthreads(); else __syncwarp();

  const int t0 = a.group > 1 ? threadIdx.x : lane;
  const int tn = a.group > 1 ? kThreads : 32;
  if (a.out_f64) {
    const long long orow = a.out_rows ? a.out_rows[row] : row;
    if (orow < 0 || orow >= a.out_n) __trap();   // an index outside out
    double* o = static_cast<double*>(a.out) + orow * total;
    for (int i = t0; i < total; i += tn) {
      const int c = my[i];
      if (c) atomicAdd(&o[i], static_cast<double>(c));
    }
  } else {
    int* o = static_cast<int*>(a.out) + row * total;
    for (int i = t0; i < total; i += tn) {
      const int c = my[i];
      if (!a.atomic_int) o[i] = c;
      else if (c) atomicAdd(&o[i], c);
    }
  }
}

template <typename T>
int launch(const void* r, long long rows, long long F, const void* sizes,
           const void* starts, const void* tops, const void* scales,
           int n_sizes, int plan, double lo, const void* divisor,
           int divisor_per_row, void* out, int out_f64, const void* out_rows,
           long long out_n, int total_bins, int group, int col_splits,
           int vectorized, void* stream) {
  if (rows <= 0 || F <= 0) return 0;
  if (n_sizes < 1 || n_sizes > kMaxSizes || (group != 1 && group != kWarps) ||
      col_splits < 1)
    return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const int vec = vectorized ? kVec : 1;
  long long cols = (F + col_splits - 1) / col_splits;
  cols = (cols + vec - 1) / vec * vec;     // every CTA starts on a 16-byte load
  Args a{r, rows, F, static_cast<const double*>(sizes),
         static_cast<const int*>(starts), static_cast<const int*>(tops),
         static_cast<const double*>(scales), n_sizes, lo, divisor,
         divisor_per_row, out, out_f64,
         static_cast<const long long*>(out_rows), out_n, total_bins, group,
         cols, !out_f64 && col_splits > 1};
  const int sets = kWarps / group;
  const size_t smem = static_cast<size_t>(sets) * total_bins * sizeof(int);
  dim3 grid(static_cast<unsigned>((rows + sets - 1) / sets),
            static_cast<unsigned>(col_splits));
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) { kernel<<<grid, kThreads, smem, s>>>(a); };
  auto pick = [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    if (n_sizes == 6 && plan == kPlanSix) go(spike_hist_kernel<T, V, 6, kPlanSix>);
    else if (n_sizes == 1 && plan == 0) go(spike_hist_kernel<T, V, 1, 0>);
    else go(spike_hist_kernel<T, V, 0, 0>);     // every size divided
  };
  if (vectorized) pick(std::integral_constant<int, kVec>());
  else pick(std::integral_constant<int, 1>());
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SPIKE_HIST_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* r, long long rows, long long F,            \
                      const void* sizes, const void* starts,                 \
                      const void* tops, const void* scales, int n_sizes,     \
                      int plan,                                              \
                      double lo, const void* divisor, int divisor_per_row,   \
                      void* out, int out_f64, const void* out_rows,          \
                      long long out_n, int total_bins, int group,            \
                      int col_splits, int vectorized, void* stream) {        \
    return launch<T>(r, rows, F, sizes, starts, tops, scales, n_sizes,      \
                     plan, lo,                                               \
                     divisor, divisor_per_row, out, out_f64, out_rows,       \
                     out_n, total_bins, group, col_splits, vectorized,       \
                     stream);                                                \
  }

SPIKE_HIST_ENTRY(spike_hist_f64, double)
SPIKE_HIST_ENTRY(spike_hist_f32, float)
