// Coordinate-wise median AND beta-trimmed mean over m worker rows, from one
// read of the rows, on Hopper.
//
// Replaces the Pallas TPU kernel of the JAX reference
// (src/repro/kernels/robust_agg.py):
//   ra_fused  <- fused_median_trimmed_pallas  (_fused_kernel)
//
// The median and the trimmed mean alone (median_pallas, trimmed_mean_pallas)
// are no longer here: their programs are compiled in, on integer keys in
// registers (select_program.cuh, generated by select_codegen.py).  This
// kernel still walks its comparator list at runtime and is next to be
// redesigned the same way.
//
// It runs the pruned compare-exchange program of the union rank set
// (selection_network.fused_program, uploaded by the wrapper as (i, j) byte
// pairs) on every column of an (m, n) row-major matrix.
//
// Bound: memory.  The work is m*n*s bytes read plus 2*n*s written, s the
// element size, against about 2 compares per comparator per coordinate: at
// m=32 that is ~130 bytes against ~310 ALU operations per coordinate, far
// below the card's operations-per-byte balance point.
//
// Design (the simple, exact version):
// - one thread owns one coordinate; its column of m values lives in
//   shared memory as f32, laid out (m, kBlock) so that a warp's accesses
//   to one row hit 32 consecutive banks;
// - rows are read coalesced: neighbouring threads read neighbouring
//   coordinates of the same row, so each row of a block is one 512-byte
//   (f32) or 256-byte (bf16) transaction;
// - bf16 values are widened exactly to f32, compared, and written back
//   exactly (a value that came from bf16 rounds to itself);
// - min/max are written as explicit compares that reproduce jnp.minimum /
//   jnp.maximum: NaN propagates and -0 < +0 (fminf/fmaxf drop NaN);
// - even-m median is (lo + hi) * 0.5 in f32; the band is summed in rank
//   order in f32 and divided truly.  The _rn intrinsics keep the compiler
//   from contracting or reassociating any of it.
// The whole column stays on chip, so every byte is read once and written
// once: the kernel moves exactly the bytes of the bound.  It does not run
// at that bound: on an H100 SXM (700 W) at m=32, n=2^24 f32 it takes ~3.7
// ms against 0.68 ms, and the time grows with the comparator count, so
// walking a runtime comparator list from shared memory is bound by the
// instruction rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // threads per block; m <= 64 -> <= 32 KB smem

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kBlock)
fused_select_kernel(const T* __restrict__ x, int m, long long n,
                    const uint8_t* __restrict__ pairs, int ncomp, int trim,
                    T* __restrict__ med, T* __restrict__ tm) {
  extern __shared__ float col[];  // (m, kBlock)
  const int t = threadIdx.x;
  const long long c = (long long)blockIdx.x * kBlock + t;
  if (c >= n) return;  // no barrier below: each thread touches only its column
  float* v = col + t;
  for (int i = 0; i < m; ++i) v[i * kBlock] = to_f32(x[(long long)i * n + c]);
  for (int k = 0; k < ncomp; ++k) {
    const int i = __ldg(pairs + 2 * k) * kBlock;
    const int j = __ldg(pairs + 2 * k + 1) * kBlock;
    const float a = v[i], b = v[j];
    v[i] = ieee_min(a, b);
    v[j] = ieee_max(a, b);
  }
  const int h = m / 2;
  const float r = (m & 1) ? v[h * kBlock]
                          : __fmul_rn(__fadd_rn(v[(h - 1) * kBlock], v[h * kBlock]), 0.5f);
  store(med + c, r);
  float acc = v[trim * kBlock];
  for (int i = trim + 1; i < m - trim; ++i) acc = __fadd_rn(acc, v[i * kBlock]);
  store(tm + c, __fdiv_rn(acc, (float)(m - 2 * trim)));
}

template <typename T>
int launch(const void* x, int m, long long n, const void* pairs, int ncomp, int trim,
           void* med, void* tm, void* stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  const size_t smem = (size_t)m * kBlock * sizeof(float);
  fused_select_kernel<T><<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      (const T*)x, m, n, (const uint8_t*)pairs, ncomp, trim, (T*)med, (T*)tm);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int ra_fused(const void* x, int m, long long n, const void* pairs, int ncomp,
                        int trim, void* med, void* tm, int is_bf16, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(x, m, n, pairs, ncomp, trim, med, tm, stream)
                 : launch<float>(x, m, n, pairs, ncomp, trim, med, tm, stream);
}

extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
