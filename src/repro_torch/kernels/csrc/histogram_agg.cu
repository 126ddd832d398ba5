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
// The launch plan (vector width, warps, column tile, staging rows, shared
// bytes, shared or global variant) is chosen in Python
// (histogram_agg.minmax_plan / histogram_plan) and passed in; the entry
// points reject a plan that the data cannot take.
//
// hg_minmax: a block of 32 x W threads owns a tile of 32*V columns.  Lane
// l owns V neighbouring columns (V = 4 f32 or 8 bf16 with 16-byte loads
// when the pointer and n allow, else 1); warp w reduces rows w, w + W,
// w + 2W, ... with four rows' loads issued before their compares.  The W
// partial results meet in shared memory and are combined in warp order.
// min/max under jnp's rules (NaN propagates, -0 < +0) are exact and do not
// depend on the order of the rows, so any split gives the same bits.  The
// compares are branch-free selects; the warps start from +inf / -inf,
// which every value (NaN included) replaces exactly.
//
// hg_histogram, shared variant: a block owns a tile of T columns (a power
// of two) and keeps its counts (int) and sums (f32) in dynamic shared
// memory as [bin][column], so a thread of column t only touches banks
// congruent to t modulo T (T <= 32) or to t modulo 32.  For each batch of
// S rows all threads load the rows (coalesced, one batch ahead in
// registers), compute the bins with _hist_kernel's arithmetic and add 1
// to the bin's count with a shared-memory integer atomicAdd: an integer
// count is exact in any order, and equals the plain version's f32 +1
// chain while it stays <= 2^24, so the plan takes this variant only for
// rows <= 2^24.  With sums, the threads also stage (bin, value) in shared
// memory, and one walker per column adds the batch's values in row order:
// it takes 8 rows at a time, loads their bins' running sums at once,
// chains rows that share a bin in registers (in row order) and stores
// back in row order, so a bin's last store holds its latest value.  Every
// (bin, column) sum is thus the row-ordered f32 __fadd_rn sequence of the
// plain version (one scatter_add_ per row), bit for bit, with no atomics
// on float data.  The tile is zeroed by all threads and flushed once,
// coalesced: each output byte is written exactly once.
//
// hg_histogram, global variant (when one column's histogram cannot fit in
// shared memory, or rows > 2^24): one thread per column zeroes its column
// and adds its rows in row order in device memory, as the first version
// did.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 5b; the
// numbers are in PERF.md): hg_minmax at 256 x 2^20 runs at ~90 % of the
// HBM bound in f32 and ~75 % in bf16, and at the federated chunk (512 x 32)
// in ~4 us of device time, under torch.aminmax's; per call there the
// ctypes wrapper's host time dominates.  hg_histogram takes ~4 us (counts)
// and ~13 us (sums) at the federated chunk, where the walkers' row chains
// set the time, and ~0.7 / ~1.2 ms at 256 x 2^20 x 128 bins (~70 % / ~50 %
// of the bound), where a block's batches alternate between loading and
// walking.
//
// The bin is _hist_kernel's: f32 (x - lo) / safe_w with safe_w = w when
// w > 0 else 1, floor, clip in float to [0, nbins - 1] (NaN -> 0), then
// convert.  __fsub_rn/__fdiv_rn keep nvcc from contracting or
// approximating the division.  bf16 values are widened exactly to f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGlobalBlock = 128;        // global histogram: threads per block
constexpr int kMaxHistThreads = 512;     // shared histogram: threads per block, at most
constexpr int kLoads = 8;                // rows a histogram thread loads per batch, at most
constexpr int kGroup = 8;                // rows a histogram walker takes at a time
constexpr int kSmemLimit = 232448;       // dynamic shared memory a block can use
constexpr int kMaxSharedRows = 1 << 24;  // int counts equal f32 +1 chains up to here

__device__ __forceinline__ float ieee_min(float a, float b) {
  float r = (b < a) ? b : a;
  r = (a == b) ? __int_as_float(__float_as_int(a) | __float_as_int(b)) : r;  // -0 < +0
  return (a != a || b != b) ? __fadd_rn(a, b) : r;  // NaN in, NaN out
}

__device__ __forceinline__ float ieee_max(float a, float b) {
  float r = (b > a) ? b : a;
  r = (a == b) ? __int_as_float(__float_as_int(a) & __float_as_int(b)) : r;
  return (a != a || b != b) ? __fadd_rn(a, b) : r;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One lane's V neighbouring columns of one row, widened to f32.
__device__ __forceinline__ void load_cols(const float* p, float (&v)[1]) { v[0] = p[0]; }
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load_cols(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: the low half is the lower column
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(V == 8 ? 512 : 1024)
minmax_kernel(const T* __restrict__ x, int rows, long long n,
              float* __restrict__ lo, float* __restrict__ hi) {
  extern __shared__ float part[];  // [2][W][32 * V]: the warps' partial min, then max
  constexpr int kTile = 32 * V;
  const int lane = threadIdx.x, warp = threadIdx.y, W = blockDim.y;
  const long long tile0 = (long long)blockIdx.x * kTile;
  const long long c = tile0 + (long long)lane * V;
  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) { a[k] = __int_as_float(0x7f800000); b[k] = -a[k]; }
  if (c < n) {  // with V > 1, n % V == 0: the lane's V columns are all in
    int r = warp;
    for (; r + 3 * W < rows; r += 4 * W) {
      float v0[V], v1[V], v2[V], v3[V];
      load_cols(x + (long long)r * n + c, v0);
      load_cols(x + (long long)(r + W) * n + c, v1);
      load_cols(x + (long long)(r + 2 * W) * n + c, v2);
      load_cols(x + (long long)(r + 3 * W) * n + c, v3);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] = ieee_min(ieee_min(ieee_min(ieee_min(a[k], v0[k]), v1[k]), v2[k]), v3[k]);
        b[k] = ieee_max(ieee_max(ieee_max(ieee_max(b[k], v0[k]), v1[k]), v2[k]), v3[k]);
      }
    }
    for (; r < rows; r += W) {
      float v[V];
      load_cols(x + (long long)r * n + c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) { a[k] = ieee_min(a[k], v[k]); b[k] = ieee_max(b[k], v[k]); }
    }
  }
  float* pmin = part;
  float* pmax = part + W * kTile;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    pmin[warp * kTile + lane * V + k] = a[k];
    pmax[warp * kTile + lane * V + k] = b[k];
  }
  __syncthreads();
  for (int j = warp * 32 + lane; j < kTile; j += 32 * W) {
    if (tile0 + j >= n) break;
    float mn = pmin[j], mx = pmax[j];
    for (int w = 1; w < W; ++w) {  // fixed order: warp 0, 1, ..., W - 1
      mn = ieee_min(mn, pmin[w * kTile + j]);
      mx = ieee_max(mx, pmax[w * kTile + j]);
    }
    lo[tile0 + j] = mn;
    hi[tile0 + j] = mx;
  }
}

// A histogram thread's rows of the batch at `base`: r0 + u * rstep for
// u < kLoads, of the column `col` points into.  The loads have no branch
// between them, so all of them are in flight at once.
template <typename T>
__device__ __forceinline__ void fetch_rows(float (&pre)[kLoads], const T* col, long long n,
                                           int base, int rows, int stage_rows, int r0,
                                           int rstep, bool live) {
  const int nr = (rows - base < stage_rows) ? rows - base : stage_rows;
  const T* src = col + (long long)base * n;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int r = r0 + u * rstep;
    pre[u] = (live && r < nr) ? to_f32(src[(long long)r * n]) : 0.0f;
  }
}

template <typename T, bool kSums>
__global__ void __launch_bounds__(kMaxHistThreads, 1)  // (.., 1): ptxas spilled without it
histogram_kernel_smem(const T* __restrict__ x, int rows, long long n,
                      const float* __restrict__ lo, const float* __restrict__ width,
                      int nbins, int log2_tile, int stage_rows,
                      float* __restrict__ counts, float* __restrict__ sums) {
  extern __shared__ __align__(16) int smem[];
  const int tile = 1 << log2_tile;
  const int cells = nbins * tile;
  int* hc = smem;                                   // [nbins][tile] counts
  float* hs = (float*)(hc + cells);                 // [nbins][tile] sums (kSums)
  int* sb = (int*)(hs + cells);                     // [stage_rows][tile] bin offsets (kSums)
  float* sv = (float*)(sb + stage_rows * tile);     // [stage_rows][tile] values (kSums)
  const int t = threadIdx.x, nt = blockDim.x;       // nt is a multiple of tile
  const long long c0 = (long long)blockIdx.x * tile;
  const int cols = (int)((n - c0 < tile) ? (n - c0) : tile);

  for (int i = t; i < (kSums ? 2 : 1) * cells; i += nt) hc[i] = 0;  // 0 is also +0.0f
  __syncthreads();

  // loading: this thread's column j, rows r0 + u * rstep of each batch
  const int j = t & (tile - 1);
  const int r0 = t >> log2_tile, rstep = nt >> log2_tile;
  const bool live = j < cols;
  float l = 0.0f, safe_w = 1.0f;
  if (live) {
    l = lo[c0 + j];
    const float w = width[c0 + j];
    safe_w = (w > 0.0f) ? w : 1.0f;
  }
  const float top = (float)(nbins - 1);

  // A thread's rows of a batch are loaded into registers one batch ahead
  // (the plan keeps stage_rows * tile <= threads * kLoads), so the next
  // batch is in flight while this one is counted and walked.
  float pre[kLoads];
  fetch_rows(pre, x + c0 + j, n, 0, rows, stage_rows, r0, rstep, live);
  for (int base = 0; base < rows; base += stage_rows) {
    const int nr = (rows - base < stage_rows) ? rows - base : stage_rows;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int r = r0 + u * rstep;
      if (live && r < nr) {
        const float v = pre[u];
        float q = floorf(__fdiv_rn(__fsub_rn(v, l), safe_w));
        q = (q != q) ? 0.0f : fminf(fmaxf(q, 0.0f), top);  // clip in float; NaN -> 0
        const int at = (int)q * tile;  // the bin's offset in [bin][tile]
        atomicAdd(&hc[at + j], 1);  // an integer count: exact in any order
        if (kSums) {
          sb[r * tile + j] = at;
          sv[r * tile + j] = v;
        }
      }
    }
    if (kSums) __syncthreads();  // the batch is staged
    if (base + stage_rows < rows)
      fetch_rows(pre, x + c0 + j, n, base + stage_rows, rows, stage_rows, r0, rstep, live);
    if (kSums && t < cols) {  // walker of column t: the batch's sums in row order
      int r = 0;
      for (; r + kGroup <= nr; r += kGroup) {
        int at[kGroup];
        float v[kGroup], ps[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          at[k] = sb[(r + k) * tile + t] + t;
          v[k] = sv[(r + k) * tile + t];
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) ps[k] = hs[at[k]];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          float s = ps[k];
#pragma unroll
          for (int i = 0; i < k; ++i)  // the latest earlier row of the same bin
            s = (at[i] == at[k]) ? ps[i] : s;
          ps[k] = __fadd_rn(s, v[k]);
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k)  // in row order: a bin's last store wins
          hs[at[k]] = ps[k];
      }
      for (; r < nr; ++r) {
        const int at = sb[r * tile + t] + t;
        hs[at] = __fadd_rn(hs[at], sv[r * tile + t]);
      }
    }
    if (kSums) __syncthreads();  // the staging buffer is free again
  }
  __syncthreads();  // every count and sum is in

  for (int i = t; i < cells; i += nt) {  // coalesced along the columns
    const int jj = i & (tile - 1);
    if (jj < cols) {
      const long long at = (long long)(i >> log2_tile) * n + c0 + jj;
      counts[at] = (float)hc[i];  // exact: rows <= 2^24
      if (kSums) sums[at] = hs[i];
    }
  }
}

template <typename T, bool kSums>
__global__ void __launch_bounds__(kGlobalBlock)
histogram_kernel_global(const T* __restrict__ x, int rows, long long n,
                        const float* __restrict__ lo, const float* __restrict__ width,
                        int nbins, float* __restrict__ counts, float* __restrict__ sums) {
  const long long c = (long long)blockIdx.x * kGlobalBlock + threadIdx.x;
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

template <typename T, int V>
int launch_minmax(const void* x, int rows, long long n, void* lo, void* hi, int warps,
                  void* stream) {
  const long long blocks = (n + 32 * V - 1) / (32 * V);
  const size_t smem = (size_t)2 * warps * 32 * V * sizeof(float);
  if (warps * 32 > (V == 8 ? 512 : 1024) || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  minmax_kernel<T, V><<<(unsigned)blocks, dim3(32, warps), smem, (cudaStream_t)stream>>>(
      (const T*)x, rows, n, (float*)lo, (float*)hi);
  return (int)cudaGetLastError();
}

template <typename T, bool kSums>
int launch_histogram(const void* x, int rows, long long n, const void* lo, const void* width,
                     int nbins, void* counts, void* sums, int log2_tile, int threads,
                     int stage_rows, int smem_bytes, void* stream) {
  if (smem_bytes == 0) {
    const long long blocks = (n + kGlobalBlock - 1) / kGlobalBlock;
    histogram_kernel_global<T, kSums><<<(unsigned)blocks, kGlobalBlock, 0,
                                        (cudaStream_t)stream>>>(
        (const T*)x, rows, n, (const float*)lo, (const float*)width, nbins, (float*)counts,
        (float*)sums);
    return (int)cudaGetLastError();
  }
  const int tile = 1 << log2_tile;
  const size_t need = kSums ? (size_t)8 * ((size_t)nbins + stage_rows) * tile
                            : (size_t)4 * nbins * tile;
  if (need > (size_t)smem_bytes || smem_bytes > kSmemLimit || threads % tile != 0 ||
      threads % 32 != 0 || threads > kMaxHistThreads || stage_rows < 1 ||
      stage_rows * tile > threads * kLoads || rows > kMaxSharedRows)
    return (int)cudaErrorInvalidValue;
  static int granted = 48 * 1024;  // the default; raised once per instantiation
  if (smem_bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        histogram_kernel_smem<T, kSums>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    granted = kSmemLimit;
  }
  const long long blocks = (n + tile - 1) / tile;
  histogram_kernel_smem<T, kSums><<<(unsigned)blocks, threads, smem_bytes,
                                    (cudaStream_t)stream>>>(
      (const T*)x, rows, n, (const float*)lo, (const float*)width, nbins, log2_tile,
      stage_rows, (float*)counts, (float*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a plan the
// data cannot take.  lo/hi/width/counts/sums are f32; x is f32 or, with
// is_bf16, bf16.
//
// hg_minmax: vec is 1, or 16 bytes' worth (4 f32, 8 bf16), which needs a
// 16-byte aligned x and n % vec == 0; warps is W in 1..32.
extern "C" int hg_minmax(const void* x, int rows, long long n, void* lo, void* hi, int is_bf16,
                         int vec, int warps, void* stream) {
  if (warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  if (vec != 1) {
    if ((uintptr_t)x % 16 != 0 || vec != (is_bf16 ? 8 : 4) || n % vec != 0)
      return (int)cudaErrorInvalidValue;
    return is_bf16 ? launch_minmax<__nv_bfloat16, 8>(x, rows, n, lo, hi, warps, stream)
                   : launch_minmax<float, 4>(x, rows, n, lo, hi, warps, stream);
  }
  return is_bf16 ? launch_minmax<__nv_bfloat16, 1>(x, rows, n, lo, hi, warps, stream)
                 : launch_minmax<float, 1>(x, rows, n, lo, hi, warps, stream);
}

// hg_histogram: writes no sums when sums is NULL.  smem_bytes 0 takes the
// global variant; otherwise a block of `threads` threads owns 2^log2_tile
// columns and stages stage_rows rows at a time in smem_bytes of shared
// memory.
extern "C" int hg_histogram(const void* x, int rows, long long n, const void* lo,
                            const void* width, int nbins, void* counts, void* sums,
                            int is_bf16, int log2_tile, int threads, int stage_rows,
                            int smem_bytes, void* stream) {
  if (sums == nullptr) {
    return is_bf16
        ? launch_histogram<__nv_bfloat16, false>(x, rows, n, lo, width, nbins, counts, sums,
                                                 log2_tile, threads, stage_rows, smem_bytes,
                                                 stream)
        : launch_histogram<float, false>(x, rows, n, lo, width, nbins, counts, sums,
                                         log2_tile, threads, stage_rows, smem_bytes, stream);
  }
  return is_bf16
      ? launch_histogram<__nv_bfloat16, true>(x, rows, n, lo, width, nbins, counts, sums,
                                              log2_tile, threads, stage_rows, smem_bytes,
                                              stream)
      : launch_histogram<float, true>(x, rows, n, lo, width, nbins, counts, sums, log2_tile,
                                      threads, stage_rows, smem_bytes, stream);
}

extern "C" const char* hg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
