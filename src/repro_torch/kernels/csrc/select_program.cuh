// Coordinate-wise median (B1), trimmed mean (B2), and both from one read
// (B3) over m worker rows on Hopper: the comparator programs of
// selection_network.py compiled in.
//
// Replaces the Pallas TPU kernels of the JAX reference
// (src/repro/kernels/robust_agg.py):
//   median kernels        <- median_pallas                (_median_kernel)
//   trimmed-mean kernels  <- trimmed_mean_pallas          (_trimmed_mean_kernel)
//   fused kernels         <- fused_median_trimmed_pallas  (_fused_kernel)
//
// This header holds what every program shares.  The programs are generated
// by src/repro_torch/kernels/select_codegen.py: one struct per program
// (median_program(m), trimmed_program(m, trim) or fused_program(m, trim))
// whose run() is one CX(i, j) per comparator in the program's order, and
// one extern "C" entry per (program, dtype) that calls sel::launch.  The
// generated .cu files are written under build/repro_torch/ and built with
// nvcc, many programs to a library (robust_agg.prepare).
//
// Bound: memory for f32, the integer units for bf16 and f16.  A call reads m*n*s
// bytes and writes n*s per output (s the element size; B3 writes two).
// The work is one integer min and one max per comparator per coordinate
// (per two coordinates for bf16 and f16, whose 16-bit keys are packed two to a
// register) plus a few integer operations per element for the keys and the
// NaN flag.  Hopper issues 32-bit and packed 16x2 integer min/max (VIMNMX,
// VIMNMX.S16x2) at one rate (scripts/select_variants.py measures it).  At
// m = 32 the median program has 157 comparators: in f32 ~440 operations a
// coordinate against 130 bytes, which the integer units finish in less
// time than HBM takes to deliver the bytes; in bf16 and f16 the bytes halve, and
// packing halves the exchanges, so both limits stay close.
//
// B3: fused_program(m, trim) has the same comparators and ranks as
// trimmed_program(m, trim), since the band [trim, m - trim) always holds
// the median ranks (2 * trim < m).  So the fused kernel is the trimmed
// kernel with a second output: the median comes from the same key
// registers (the middle wire, or the f32 midpoint of the two middle wires)
// and costs one more store of n*s bytes.  No comparator list is walked at
// runtime: every kernel's indices are compile-time constants.
//
// Design:
// - Keys.  Each f32 value's bits b map to the int32 key
//   b ^ ((b >> 31) & 0x7fffffff); each bf16 or f16 value's 16 bits h to the
//   int16 key h ^ ((h >> 15) & 0x7fff), two to a register (coordinate 2j in
//   the low half).  On non-NaN values the key order is exactly jnp.minimum /
//   jnp.maximum's order in every one of the three types (sign-magnitude
//   bits, the same map): -0 < +0, and +-inf and subnormals fall in place.
//   A comparator is one integer min and one max in registers (__vmins2 /
//   __vmaxs2 on a 16-bit pair); decoding is the same map, then the exact
//   widening to f32 (a shift for bf16, __half2float for f16, subnormals
//   included).
// - NaN.  Under jnp.minimum/maximum a NaN spreads to both outputs of every
//   comparator it touches, and in every program every input wire reaches
//   every requested rank wire (tests/test_torch_select_codegen.py checks
//   this for m in 1..64, every trim), so a column holding a NaN gives NaN
//   at every requested rank.  The flag is the column's largest |bits|
//   (NaN iff above +inf's bits: 0x7f800000 f32, 0x7f80 bf16, 0x7c00 f16),
//   taken at load time; the output is NaN there.
// - Registers.  A thread owns V coordinates (select_codegen.coords_per_
//   thread: at most 64 registers of keys, m * V for f32, m * V / 2 for
//   bf16 and f16) and holds all its keys in registers: the program's
//   indices are compile-time constants.
// - Loads.  A leaf whose pointers are V-element aligned and whose n is a
//   multiple of V takes one V-wide load per row (16 bytes at V = 4 f32 or
//   V = 8 bf16 / f16) of V neighbouring coordinates; all m loads of a thread are
//   issued before the first compare.  Otherwise the leaf takes the scalar
//   path: thread t of a tile owns coordinates t, t + kThreads, ..., each
//   load coalesced across the warp, with the ragged edge masked.
// - Leaves.  One launch covers up to kMaxLeaves leaves: their (input,
//   output, second output, n, vector) records and each leaf's first block
//   travel by value in the kernel's parameters (__grid_constant__), so
//   there is no copy to the device and no concatenation.  A block finds
//   its leaf from the prefix of tile counts; each leaf keeps its own load
//   path.
// - Arithmetic, as the plain version's (selection_network.median_from_rows
//   and band_mean_from_rows): even-m median (lo + hi) * 0.5 in f32; the band
//   summed in rank order in f32 and divided truly (__fdiv_rn, after all the
//   loads); bf16 and f16 rounded once, with __float2bfloat16_rn /
//   __float2half_rn (round to nearest even, to a subnormal where the value
//   is one, as torch's .to(dtype) rounds).  B3 computes each
//   output exactly as B1 and B2 do, from the same keys and NaN flag.  The
//   _rn intrinsics keep the compiler from contracting or reassociating any
//   of it, and the build does not flush subnormals.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sel {

constexpr int kThreads = 128;   // select_codegen.THREADS
constexpr int kMaxLeaves = 32;  // select_codegen.MAX_LEAVES
constexpr int kMedian = 0;
constexpr int kTrimmed = 1;
constexpr int kFused = 2;  // out: the median, out2: the trimmed mean

struct Leaf {
  const void* x;  // (m, n) row-major
  void* out;      // (n,)
  void* out2;     // (n,) for kFused, else null
  long long n;
  int vec;        // 1: V-wide loads and stores
};

struct Batch {
  Leaf leaf[kMaxLeaves];
  long long first_tile[kMaxLeaves];  // a leaf's first block; LLONG_MAX past the last leaf
};

// f32: one int32 key a register
__device__ __forceinline__ int key_of(uint32_t bits) {
  return (int)(bits ^ ((uint32_t)((int)bits >> 31) >> 1));
}

__device__ __forceinline__ float value_of(int key) {
  return __uint_as_float((uint32_t)key ^ ((uint32_t)(key >> 31) >> 1));
}

// bf16 and f16: two 16-bit keys a register (coordinate 2j in the low half)
__device__ __forceinline__ uint32_t keys2_of(uint32_t w) {
  return w ^ (((w >> 15) & 0x00010001u) * 0x7fffu);
}

// the 16 bits of the key in half `half` of w (the same map undoes itself)
__device__ __forceinline__ uint32_t bits_of_half(uint32_t w, int half) {
  const uint32_t key = half ? w >> 16 : w & 0xffffu;
  return key ^ ((key >> 15) * 0x7fffu);
}

template <int W>
__device__ __forceinline__ void exchange(int (&a)[W], int (&b)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int lo = min(a[w], b[w]);
    b[w] = max(a[w], b[w]);
    a[w] = lo;
  }
}

template <int W>
__device__ __forceinline__ void exchange(uint32_t (&a)[W], uint32_t (&b)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {  // VIMNMX.S16x2: both halves in one instruction
    const uint32_t lo = __vmins2(a[w], b[w]);
    b[w] = __vmaxs2(a[w], b[w]);
    a[w] = lo;
  }
}

// one comparator of a generated program: min to wire i, max to wire j
#define CX(i, j) ::sel::exchange(k[i], k[j])

template <typename T> struct Elem;

// kInf: +inf's bits (above them |bits| is a NaN); widen: 16 bits -> the
// exact f32 value; bits: f32 -> the type's bits, rounded once to nearest even
template <> struct Elem<float> {
  static constexpr int kSize = 4;
  static constexpr uint32_t kInf = 0x7f800000u;
  using Key = int;  // one key a register
  static __device__ uint32_t raw(const void* p, long long i) {
    return __ldg((const unsigned int*)p + i);
  }
  static __device__ void put(void* p, long long i, float r) { ((float*)p)[i] = r; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kSize = 2;
  static constexpr uint32_t kInf = 0x7f80u;
  using Key = uint32_t;  // two keys a register
  static __device__ uint32_t raw(const void* p, long long i) {
    return __ldg((const unsigned short*)p + i);
  }
  static __device__ float widen(uint32_t h) { return __uint_as_float(h << 16); }
  static __device__ uint32_t bits(float r) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r));
  }
  static __device__ void put(void* p, long long i, float r) {
    ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(r);
  }
};

template <> struct Elem<__half> {
  static constexpr int kSize = 2;
  static constexpr uint32_t kInf = 0x7c00u;
  using Key = uint32_t;  // two keys a register
  static __device__ uint32_t raw(const void* p, long long i) {
    return __ldg((const unsigned short*)p + i);
  }
  static __device__ float widen(uint32_t h) {
    return __half2float(__ushort_as_half((unsigned short)h));
  }
  static __device__ uint32_t bits(float r) {
    return (uint32_t)__half_as_ushort(__float2half_rn(r));
  }
  static __device__ void put(void* p, long long i, float r) {
    ((__half*)p)[i] = __float2half_rn(r);
  }
};

// W 32-bit words from one 4*W-byte load
template <int W>
__device__ __forceinline__ void load_words(const void* a, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 q = __ldg((const uint4*)a);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (W == 2) {
    const uint2 q = __ldg((const uint2*)a);
    w[0] = q.x; w[1] = q.y;
  } else {
    w[0] = __ldg((const unsigned int*)a);
  }
}

// V results to V neighbouring elements at element i, one V*s-byte store
template <typename T, int V>
__device__ __forceinline__ void store_vec(void* p, long long i, const float (&r)[V]) {
  constexpr int W = V * Elem<T>::kSize / 4;
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (Elem<T>::kSize == 4) {
      w[j] = __float_as_uint(r[j]);
    } else {
      w[j] = Elem<T>::bits(r[2 * j]) | (Elem<T>::bits(r[2 * j + 1]) << 16);
    }
  }
  char* a = (char*)p + i * Elem<T>::kSize;
  if constexpr (W == 4) {
    *(uint4*)a = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (W == 2) {
    *(uint2*)a = make_uint2(w[0], w[1]);
  } else {
    *(unsigned int*)a = w[0];
  }
}

// the value of wire i at coordinate v, as f32 (exact)
template <typename T, typename K, int M, int W>
__device__ __forceinline__ float value(const K (&k)[M][W], int i, int v) {
  if constexpr (std::is_same_v<K, int>) {  // one key a register
    return value_of(k[i][v]);
  } else {
    return Elem<T>::widen(bits_of_half(k[i][v / 2], v & 1));
  }
}

// the median at coordinate v: the middle wire, or the f32 midpoint of the
// two middle wires
template <typename T, int M, typename K, int W>
__device__ __forceinline__ float median_of(const K (&k)[M][W], int v) {
  if constexpr (M & 1) {
    return value<T>(k, M / 2, v);
  } else {
    return __fmul_rn(__fadd_rn(value<T>(k, M / 2 - 1, v), value<T>(k, M / 2, v)), 0.5f);
  }
}

// the band [kTrim, M - kTrim) at coordinate v, summed in rank order and
// divided truly
template <typename T, int M, int kTrim, typename K, int W>
__device__ __forceinline__ float band_mean_of(const K (&k)[M][W], int v) {
  float acc = value<T>(k, kTrim, v);
#pragma unroll
  for (int i = kTrim + 1; i < M - kTrim; ++i) acc = __fadd_rn(acc, value<T>(k, i, v));
  return __fdiv_rn(acc, (float)(M - 2 * kTrim));
}

// the requested ranks' keys -> the output values (r; r2 for kFused), NaN
// where the column held one
template <typename T, int M, int V, int kKind, int kTrim, typename K, int W>
__device__ __forceinline__ void finish(const K (&k)[M][W], const uint32_t (&mag)[W],
                                       float (&r)[V], float (&r2)[V]) {
  constexpr bool kPacked = W != V;
  const float qnan = __uint_as_float(0x7fc00000u);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool nan = (kPacked ? (v & 1 ? mag[v / 2] >> 16 : mag[v / 2] & 0xffffu) : mag[v])
                     > Elem<T>::kInf;
    if constexpr (kKind == kTrimmed) {
      r[v] = nan ? qnan : band_mean_of<T, M, kTrim>(k, v);
    } else {
      r[v] = nan ? qnan : median_of<T>(k, v);
    }
    if constexpr (kKind == kFused) r2[v] = nan ? qnan : band_mean_of<T, M, kTrim>(k, v);
  }
}

template <typename T, class P, int V, int kKind, int kTrim>
__global__ void __launch_bounds__(kThreads)
leaf_select_kernel(const __grid_constant__ Batch batch) {
  constexpr int M = P::kM;
  constexpr bool kPacked = Elem<T>::kSize == 2;
  constexpr int W = kPacked ? V / 2 : V;  // key registers a row
  using K = typename Elem<T>::Key;
  static_assert(!kPacked || V % 2 == 0, "16-bit keys come in pairs");
  const long long b = blockIdx.x;
  int l = 0;
#pragma unroll
  for (int j = 1; j < kMaxLeaves; ++j) l += b >= batch.first_tile[j];
  const Leaf& leaf = batch.leaf[l];
  const long long n = leaf.n;
  const long long tile = b - batch.first_tile[l];
  const bool vec = leaf.vec;
  // vector path: V neighbouring coordinates; scalar path: c0 + v * kThreads
  const long long c0 = vec ? (tile * kThreads + threadIdx.x) * V
                           : tile * kThreads * V + threadIdx.x;
  if (c0 >= n) return;  // no barrier below

  // raw words: f32 bits of coordinate w, or 16-bit bits of coordinates 2w
  // (low half) and 2w + 1 (high half); all loads before the first compare
  uint32_t raw[M][W];
  if (vec) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      load_words<W>((const char*)leaf.x + (i * n + c0) * Elem<T>::kSize, raw[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int w = 0; w < W; ++w) raw[i][w] = 0u;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long c = c0 + (long long)v * kThreads;
        const uint32_t e = c < n ? Elem<T>::raw(leaf.x, i * n + c) : 0u;
        if constexpr (kPacked) {
          raw[i][v / 2] |= e << (16 * (v & 1));
        } else {
          raw[i][v] = e;
        }
      }
    }
  }
  K k[M][W];
  uint32_t mag[W];  // the largest |bits|: NaN iff above +inf's
#pragma unroll
  for (int w = 0; w < W; ++w) mag[w] = 0u;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if constexpr (kPacked) {
        mag[w] = __vmaxu2(mag[w], raw[i][w] & 0x7fff7fffu);
        k[i][w] = keys2_of(raw[i][w]);
      } else {
        mag[w] = max(mag[w], raw[i][w] & 0x7fffffffu);
        k[i][w] = key_of(raw[i][w]);
      }
    }
  }
  P::template run<K, W>(k);
  float r[V], r2[V];  // r2: kFused's trimmed mean
  finish<T, M, V, kKind, kTrim>(k, mag, r, r2);
  if (vec) {
    store_vec<T, V>(leaf.out, c0, r);
    if constexpr (kKind == kFused) store_vec<T, V>(leaf.out2, c0, r2);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long c = c0 + (long long)v * kThreads;
      if (c < n) {
        Elem<T>::put(leaf.out, c, r[v]);
        if constexpr (kKind == kFused) Elem<T>::put(leaf.out2, c, r2[v]);
      }
    }
  }
}

// leaves: nleaves records of 5 long longs (input pointer, output pointer,
// second output pointer (kFused; 0 otherwise), n, vector flag).  Returns
// cudaGetLastError() after the launch (0 = launched), or an error without
// launching when a record is one the kernel cannot take.
template <typename T, class P, int V, int kKind, int kTrim>
int launch(const long long* leaves, int nleaves, void* stream) {
  if (nleaves < 1 || nleaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  constexpr long long kTile = (long long)kThreads * V;
  constexpr long long kAlign = (long long)V * sizeof(T);
  Batch batch;
  long long tiles = 0;
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l >= nleaves) {
      batch.leaf[l] = Leaf{nullptr, nullptr, nullptr, 0, 0};
      batch.first_tile[l] = LLONG_MAX;
      continue;
    }
    const long long* f = leaves + 5 * l;
    if (f[3] < 1 || (kKind == kFused) != (f[2] != 0)) return (int)cudaErrorInvalidValue;
    if (f[4] && (((f[0] | f[1] | f[2]) % kAlign) || f[3] % V)) {
      return (int)cudaErrorMisalignedAddress;
    }
    batch.leaf[l] = Leaf{(const void*)f[0], (void*)f[1], (void*)f[2], f[3], (int)(f[4] != 0)};
    batch.first_tile[l] = tiles;
    tiles += (f[3] + kTile - 1) / kTile;
  }
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  leaf_select_kernel<T, P, V, kKind, kTrim>
      <<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(batch);
  return (int)cudaGetLastError();
}

}  // namespace sel
