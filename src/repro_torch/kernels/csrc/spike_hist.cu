// Spike-magnitude histograms of many rows, for every tracked bin size in one
// launch.  Hand-written for Hopper (sm_90a).
//
// Replaces: repro/kernels/spike_hist.py, spike_hist_batch_pallas
// (_batch_hist_kernel) and spike_hist_pallas (_hist_kernel), the TPU
// kernels that bin relative power r into [lo, hi) with one launch per bin
// size.  Semantics per sample: counted only if r >= lo (-inf padding and NaN
// never count); bin = min((long long)((r - lo) / c), n - 1).  The subtract
// and the IEEE divide are separate operations in the value type T (double
// for the profiling engine and the builder, float for ops.spike_hist), and
// the quotient is truncated like NumPy's astype(int64), so the counts equal
// the reference's float64 scatter exactly.  Built without fast math: the
// divide is correctly rounded.
//
// Bound: bytes.  Each sample is read once (8 B in double) and costs one
// compare, one subtract and, per bin size, one divide and one shared-memory
// atomic.  At the fleet path's shape (10,000 x 256 doubles, six bin sizes)
// one launch reads 20.5 MB and writes 2.9 MB of int32 counts.
//
// Design: one CTA owns a (row, column range) tile and keeps the counters of
// ALL bin sizes of that row in shared memory (72 ints for the six default
// sizes), so the six histograms cost one pass over the samples instead of
// six.  Neighbouring threads read neighbouring samples (coalesced loads).
// At the end the CTA adds its non-zero counters to the (rows, total_bins)
// output with integer atomics; a row is split over several CTAs only when
// there are too few rows to fill the card (the single-trace case).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSizes = 16;

template <typename T>
__global__ void spike_hist_kernel(const T* __restrict__ r, long long F,
                                  const double* __restrict__ sizes,
                                  const int* __restrict__ offsets,
                                  int n_sizes, double lo,
                                  int* __restrict__ out, int total_bins,
                                  long long cols_per_cta) {
  extern __shared__ int counts[];          // total_bins counters of one row
  __shared__ T s_size[kMaxSizes];
  __shared__ int s_off[kMaxSizes + 1];
  for (int i = threadIdx.x; i < total_bins; i += blockDim.x) counts[i] = 0;
  if (threadIdx.x < n_sizes) s_size[threadIdx.x] = static_cast<T>(sizes[threadIdx.x]);
  if (threadIdx.x <= n_sizes) s_off[threadIdx.x] = offsets[threadIdx.x];
  __syncthreads();

  const long long row = blockIdx.x;
  const T* rr = r + row * F;
  const T tlo = static_cast<T>(lo);
  const long long c0 = static_cast<long long>(blockIdx.y) * cols_per_cta;
  const long long c1 = c0 + cols_per_cta < F ? c0 + cols_per_cta : F;
  for (long long j = c0 + threadIdx.x; j < c1; j += blockDim.x) {
    const T v = rr[j];
    if (v >= tlo) {
      const T shifted = v - tlo;
      for (int b = 0; b < n_sizes; ++b) {
        const T q = shifted / s_size[b];
        long long bin = static_cast<long long>(q);   // C truncation
        const int n = s_off[b + 1] - s_off[b];
        if (bin > n - 1) bin = n - 1;
        atomicAdd(&counts[s_off[b] + static_cast<int>(bin)], 1);
      }
    }
  }
  __syncthreads();
  int* orow = out + row * total_bins;
  for (int i = threadIdx.x; i < total_bins; i += blockDim.x) {
    const int c = counts[i];
    if (c) atomicAdd(&orow[i], c);
  }
}

template <typename T>
int launch(const void* r, long long rows, long long F, const void* sizes,
           const void* offsets, int n_sizes, double lo, void* out,
           int total_bins, int col_splits, void* stream) {
  if (rows <= 0 || F <= 0) return 0;
  if (n_sizes < 1 || n_sizes > kMaxSizes) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long cols_per_cta = (F + col_splits - 1) / col_splits;
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(col_splits));
  spike_hist_kernel<T><<<grid, threads, total_bins * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), F, static_cast<const double*>(sizes),
      static_cast<const int*>(offsets), n_sizes, lo, static_cast<int*>(out),
      total_bins, cols_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spike_hist_f64(const void* r, long long rows, long long F,
                              const void* sizes, const void* offsets,
                              int n_sizes, double lo, void* out,
                              int total_bins, int col_splits, void* stream) {
  return launch<double>(r, rows, F, sizes, offsets, n_sizes, lo, out,
                        total_bins, col_splits, stream);
}

extern "C" int spike_hist_f32(const void* r, long long rows, long long F,
                              const void* sizes, const void* offsets,
                              int n_sizes, double lo, void* out,
                              int total_bins, int col_splits, void* stream) {
  return launch<float>(r, rows, F, sizes, offsets, n_sizes, lo, out,
                       total_bins, col_splits, stream);
}
