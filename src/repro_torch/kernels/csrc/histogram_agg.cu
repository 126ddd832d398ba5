// Per-coordinate min/max and equal-width histogram of a (rows, n) chunk on
// Hopper: the two passes of the federated streaming sketch.
//
// Replaces the Pallas TPU kernels of the JAX reference
// (src/repro/kernels/histogram_agg.py):
//   hg_minmax     <- minmax_pallas     (_minmax_kernel)
//   hg_histogram  <- histogram_pallas  (_hist_kernel)
//
// Bound: memory.  hg_minmax reads rows*n*s bytes (s the element size) and
// writes 2*n*4; hg_histogram reads rows*n*s + 2*n*4 and writes k*nbins*n*4
// (k = 2 with sums, 1 without).  Each does a handful of operations per
// element read, far below the card's operations-per-byte balance point.
//
// Design (the simple, exact version):
// - one thread owns one coordinate and walks the rows in order, so
//   neighbouring threads read neighbouring coordinates of one row
//   (coalesced) and no two threads ever touch the same output;
// - bf16 values are widened exactly to f32;
// - min/max are explicit compares that reproduce jnp.minimum/jnp.maximum:
//   NaN propagates and -0 < +0 (fminf/fmaxf drop NaN);
// - the bin is _hist_kernel's: f32 (x - lo) / safe_w with safe_w = w when
//   w > 0 else 1, floor, clip in float to [0, nbins - 1] (NaN -> 0, as
//   XLA's float-to-int conversion), then convert.  __fsub_rn/__fdiv_rn
//   keep nvcc from contracting or approximating the division;
// - the thread zeroes its own count (and sum) column, then adds 1 to the
//   row's bin count and x to its bin sum in row order, in device memory.
//   No atomics: the column is the thread's alone, so the sums are added
//   in a fixed order and the output is the same from run to run.
// Neither kernel runs at its bound.  On an H100 SXM (700 W) at the
// federated chunk (512 rows x 32, one block) each thread's walk over 512
// rows is a chain of dependent device-memory round trips: ~0.11 ms for
// hg_minmax and ~0.13 ms for hg_histogram against bounds of 0.02 and
// 0.06 us.  At 256 x 2^20 hg_minmax takes 0.52 ms against 0.32 ms, but
// hg_histogram takes ~41 ms with sums against 0.64 ms: its scattered
// read-modify-writes of 1 GB of counts and sums miss the 50 MB L2.  A
// privatized histogram in shared memory (nbins * threads * 4 bytes per
// output), flushed once in row order, is the next speed step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // threads per block, one coordinate each

__device__ __forceinline__ float ieee_min(float a, float b) {
  if (a != a || b != b) return __fadd_rn(a, b);  // NaN in, NaN out
  if (a < b) return a;
  if (b < a) return b;
  return __int_as_float(__float_as_int(a) | __float_as_int(b));  // -0 < +0
}

__device__ __forceinline__ float ieee_max(float a, float b) {
  if (a != a || b != b) return __fadd_rn(a, b);
  if (a > b) return a;
  if (b > a) return b;
  return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kBlock)
minmax_kernel(const T* __restrict__ x, int rows, long long n,
              float* __restrict__ lo, float* __restrict__ hi) {
  const long long c = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (c >= n) return;
  float a = to_f32(x[c]);
  float b = a;
  for (int r = 1; r < rows; ++r) {
    const float v = to_f32(x[(long long)r * n + c]);
    a = ieee_min(a, v);
    b = ieee_max(b, v);
  }
  lo[c] = a;
  hi[c] = b;
}

template <typename T, bool kSums>
__global__ void __launch_bounds__(kBlock)
histogram_kernel(const T* __restrict__ x, int rows, long long n,
                 const float* __restrict__ lo, const float* __restrict__ width,
                 int nbins, float* __restrict__ counts, float* __restrict__ sums) {
  const long long c = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (c >= n) return;
  for (int b = 0; b < nbins; ++b) {
    counts[(long long)b * n + c] = 0.0f;
    if (kSums) sums[(long long)b * n + c] = 0.0f;
  }
  const float l = lo[c];
  const float w = width[c];
  const float safe_w = (w > 0.0f) ? w : 1.0f;
  const float top = (float)(nbins - 1);
  for (int r = 0; r < rows; ++r) {
    const float v = to_f32(x[(long long)r * n + c]);
    float q = floorf(__fdiv_rn(__fsub_rn(v, l), safe_w));
    q = (q != q) ? 0.0f : fminf(fmaxf(q, 0.0f), top);  // clip in float; NaN -> 0
    const long long at = (long long)(int)q * n + c;
    counts[at] = __fadd_rn(counts[at], 1.0f);
    if (kSums) sums[at] = __fadd_rn(sums[at], v);
  }
}

template <typename T>
int launch_minmax(const void* x, int rows, long long n, void* lo, void* hi, void* stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  minmax_kernel<T><<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)x, rows, n, (float*)lo, (float*)hi);
  return (int)cudaGetLastError();
}

template <typename T, bool kSums>
int launch_histogram(const void* x, int rows, long long n, const void* lo, const void* width,
                     int nbins, void* counts, void* sums, void* stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  histogram_kernel<T, kSums><<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)x, rows, n, (const float*)lo, (const float*)width, nbins, (float*)counts,
      (float*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch (0 = launched).  lo/hi/width/counts/sums are f32; x is
// f32 or, with is_bf16, bf16.  hg_histogram writes no sums when sums is
// NULL.
extern "C" int hg_minmax(const void* x, int rows, long long n, void* lo, void* hi, int is_bf16,
                         void* stream) {
  return is_bf16 ? launch_minmax<__nv_bfloat16>(x, rows, n, lo, hi, stream)
                 : launch_minmax<float>(x, rows, n, lo, hi, stream);
}

extern "C" int hg_histogram(const void* x, int rows, long long n, const void* lo,
                            const void* width, int nbins, void* counts, void* sums,
                            int is_bf16, void* stream) {
  if (sums == nullptr) {
    return is_bf16
        ? launch_histogram<__nv_bfloat16, false>(x, rows, n, lo, width, nbins, counts, sums, stream)
        : launch_histogram<float, false>(x, rows, n, lo, width, nbins, counts, sums, stream);
  }
  return is_bf16
      ? launch_histogram<__nv_bfloat16, true>(x, rows, n, lo, width, nbins, counts, sums, stream)
      : launch_histogram<float, true>(x, rows, n, lo, width, nbins, counts, sums, stream);
}

extern "C" const char* hg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
