// The MoE combine on Hopper: each token's float32 weighted sum of the
// expert output rows it kept, and that sum's backward.
//
// Replaces no TPU kernel.  The JAX reference combines with a dense
// (B, S, E, C) einsum; the port's index form (models/moe.py) gathers a
// token's K rows of the experts' (E*B*cap, D) output instead.  As a
// PyTorch gather, ye[rows] with every dropped pair pointed at row 0, its
// backward was an index_put_ with accumulation that sorts the indices and
// walks each run of duplicates serially: tens of thousands of duplicates
// of row 0 per call at granite-moe's shapes, ~37 ms a call.  Here a
// dropped pair is never read nor written, and every kept pair owns its row
// (routing gives each (expert, batch, slot) at most one pair), so the
// backward writes each kept row once: no sort, no atomics.
//
// Bound: memory.  mc_combine reads the kept rows (kept*D*s bytes, s the
// element size) and writes the token sums (N*D*4); mc_combine_backward
// reads dy (N*D*4) and the kept rows, writes their gradients (kept*D*s),
// clears the other rows of d_ye (a memset of R*D*s before the kernel) and
// writes d_weight (N*K*4).  A few operations per byte.
//
// Layout: one block per token; a thread owns V neighbouring columns (16
// bytes of the rows: 4 f32, 8 bf16 or f16; D must be a multiple of V and
// every row buffer 16-byte aligned) and walks the token's columns with the
// block's stride.  The
// token's K <= kMaxK (row, keep, weight) triples are staged in shared
// memory.  The forward adds the kept pairs in k order, each product
// rounded before the add (__fmul_rn, __fadd_rn): the plain version's
// `ye[rows].float() * weight` summed over k.  The backward writes each kept
// row's gradient as the plain version's autograd did, the f32 product
// w * dy rounded to the row's type and then added to a zero (so -0 reads
// +0), and sums d_weight[t, k] = sum_d ye[row, d] * dy[t, d] in f32 (each
// thread in column order, then the warps' shuffles, then the warps in
// order: the same bits on every run).  A pair not kept gets d_weight 0.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;        // top-k pairs a token may have, at most
constexpr int kMaxThreads = 1024;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// the V = 16 / sizeof(T) columns of T at p widened to f32: one 16-byte load
template <typename T, int V>
__device__ __forceinline__ void load_t(const T* __restrict__ p, float (&o)[V]) {
  static_assert(V * sizeof(T) == 16, "16-byte columns");
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = to_f<T>(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_t(T* __restrict__ p, const float (&v)[V]) {
  static_assert(V * sizeof(T) == 16, "16-byte columns");
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// V f32 values at p (V a multiple of 4, p 16-byte aligned) as float4s
template <int V>
__device__ __forceinline__ void load_f(const float* __restrict__ p, float (&o)[V]) {
  static_assert(V % 4 == 0, "whole float4s");
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    o[4 * i] = q.x; o[4 * i + 1] = q.y; o[4 * i + 2] = q.z; o[4 * i + 3] = q.w;
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* __restrict__ p, const float (&v)[V]) {
  static_assert(V % 4 == 0, "whole float4s");
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                  v[4 * i + 3]);
}

// the token's pairs in shared memory; row -1 marks a pair not kept
__device__ __forceinline__ void stage_pairs(const long long* __restrict__ rows,
                                            const bool* __restrict__ keep,
                                            const float* __restrict__ weight, long long t, int K,
                                            long long* s_row, float* s_w) {
  if ((int)threadIdx.x < K) {
    const long long p = t * K + threadIdx.x;
    s_row[threadIdx.x] = keep[p] ? rows[p] : -1;
    s_w[threadIdx.x] = weight[p];
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void combine_kernel(const T* __restrict__ ye, const long long* __restrict__ rows,
                               const bool* __restrict__ keep, const float* __restrict__ weight,
                               int K, long long D, float* __restrict__ y) {
  __shared__ long long s_row[kMaxK];
  __shared__ float s_w[kMaxK];
  const long long t = blockIdx.x;
  stage_pairs(rows, keep, weight, t, K, s_row, s_w);
  for (long long c = (long long)threadIdx.x * V; c < D; c += (long long)blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) break;
      const long long r = s_row[k];
      if (r < 0) continue;
      const float w = s_w[k];
      float v[V];
      load_t<T, V>(ye + r * D + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], w));
    }
    store_f<V>(y + t * D + c, acc);
  }
}

template <typename T, int V>
__global__ void combine_backward_kernel(const float* __restrict__ dy, const T* __restrict__ ye,
                                        const long long* __restrict__ rows,
                                        const bool* __restrict__ keep,
                                        const float* __restrict__ weight, int K, long long D,
                                        T* __restrict__ d_ye, float* __restrict__ d_weight) {
  __shared__ long long s_row[kMaxK];
  __shared__ float s_w[kMaxK];
  __shared__ float s_part[kMaxK][kMaxThreads / 32];
  const long long t = blockIdx.x;
  stage_pairs(rows, keep, weight, t, K, s_row, s_w);
  float dot[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) dot[k] = 0.f;
  for (long long c = (long long)threadIdx.x * V; c < D; c += (long long)blockDim.x * V) {
    float g[V];
    load_f<V>(dy + t * D + c, g);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) break;
      const long long r = s_row[k];
      if (r < 0) continue;
      const float w = s_w[k];
      float v[V], out[V];
      load_t<T, V>(ye + r * D + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dot[k] = __fmaf_rn(v[i], g[i], dot[k]);
        out[i] = __fadd_rn(to_f<T>(from_f<T>(__fmul_rn(g[i], w))), 0.f);
      }
      store_t<T, V>(d_ye + r * D + c, out);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= K) break;
    float s = dot[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) s_part[k][warp] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < K) {
    const int k = threadIdx.x;
    float s = 0.f;
    if (s_row[k] >= 0)
      for (int w = 0; w < (int)blockDim.x / 32; ++w) s += s_part[k][w];
    d_weight[t * K + k] = s;
  }
}

int block_threads(long long D, int V) {
  const long long lanes = (D / V + 31) / 32 * 32;
  return (int)(lanes < kMaxThreads ? lanes : kMaxThreads);
}

bool valid(long long tokens, int K, long long D, int elem, const void* const* ptrs,
           int n_ptrs) {
  if (tokens < 1 || tokens > 0x7fffffffLL || K < 1 || K > kMaxK || D < 1) return false;
  if (D * elem % 16 != 0) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  return true;
}

template <typename T>
int launch_combine(const void* ye, const void* rows, const void* keep, const void* weight,
                   long long tokens, int K, long long D, void* y, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  combine_kernel<T, V><<<(unsigned)tokens, block_threads(D, V), 0, stream>>>(
      (const T*)ye, (const long long*)rows, (const bool*)keep, (const float*)weight, K, D,
      (float*)y);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* dy, const void* ye, const void* rows, const void* keep,
                    const void* weight, long long tokens, int K, long long D, long long n_rows,
                    void* d_ye, void* d_weight, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(d_ye, 0, (size_t)n_rows * D * sizeof(T), stream);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = 16 / sizeof(T);
  combine_backward_kernel<T, V><<<(unsigned)tokens, block_threads(D, V), 0, stream>>>(
      (const float*)dy, (const T*)ye, (const long long*)rows, (const bool*)keep,
      (const float*)weight, K, D, (T*)d_ye, (float*)d_weight);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for arguments
// the kernels cannot take.  dtype: 0 f32, 1 bf16, 2 f16 (ye and d_ye);
// y, dy, weight and d_weight are f32, rows int64, keep bool, all
// contiguous: ye and d_ye (n_rows, D), rows / keep / weight / d_weight
// (tokens, K), y and dy (tokens, D).  D is a multiple of 16 bytes of ye's
// type, and ye, y, dy and d_ye are 16-byte aligned.  Every
// kept pair's row must lie in [0, n_rows), and no two kept pairs may share
// a row (the backward's writes would race).

extern "C" int mc_combine(const void* ye, const void* rows, const void* keep, const void* weight,
                          long long tokens, int K, long long D, void* y, int dtype, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const void* ptrs[] = {ye, y};
  if (dtype < 0 || dtype > 2 || !valid(tokens, K, D, elem, ptrs, 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_combine<float>(ye, rows, keep, weight, tokens, K, D, y, s);
  if (dtype == 1)
    return launch_combine<__nv_bfloat16>(ye, rows, keep, weight, tokens, K, D, y, s);
  return launch_combine<__half>(ye, rows, keep, weight, tokens, K, D, y, s);
}

extern "C" int mc_combine_backward(const void* dy, const void* ye, const void* rows,
                                   const void* keep, const void* weight, long long tokens, int K,
                                   long long D, long long n_rows, void* d_ye, void* d_weight,
                                   int dtype, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const void* ptrs[] = {dy, ye, d_ye};
  if (dtype < 0 || dtype > 2 || n_rows < 0 || !valid(tokens, K, D, elem, ptrs, 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_backward<float>(dy, ye, rows, keep, weight, tokens, K, D, n_rows, d_ye,
                                  d_weight, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(dy, ye, rows, keep, weight, tokens, K, D, n_rows,
                                          d_ye, d_weight, s);
  return launch_backward<__half>(dy, ye, rows, keep, weight, tokens, K, D, n_rows, d_ye,
                                 d_weight, s);
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
