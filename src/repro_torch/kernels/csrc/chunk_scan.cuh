// Building blocks shared by the two chunk-parallel recurrence kernels
// (rwkv6_chunk.cu, ssd_chunk.cu). Plain CUDA C++, no PyTorch headers.
//
// Both kernels have one shape. A block owns one batch row, one head (or a
// few heads that share their B/C, for the SSD) and a slice of the state's
// and the output's columns, and walks the sequence chunk by chunk (the TPU
// form's sequential chunk grid axis becomes this loop). Per chunk of C <= 64
// positions it runs four products of at most 64 x 64 x 64: a C x C score
// tile, the readout (scores times values plus the decayed queries times the
// state) and the carry of the state. Around them, per chunk:
//   * the chunk's inputs arrive by cp.async into a two-stage ring in shared
//     memory: chunk c + 1 is in flight while chunk c computes (16-byte
//     copies where the pointers and strides allow, else element copies);
//   * the prefix sums of the log-decays, every exp and log, the state and
//     every accumulator are fp32 whatever the input dtype;
//   * the products run on the tensor cores, mma.sync m16n8k8 in TF32, with
//     each fp32 operand split into a TF32 "hi" part and a TF32 "lo" part of
//     the remainder: a b = hi_a hi_b + hi_a lo_b + lo_a hi_b (the dropped
//     lo_a lo_b and the truncations are ~2^-20 relative), accumulated in
//     fp32. One TF32 product
//     alone keeps ~3 decimal digits, too few for the recurrences' 1e-4
//     (tests/test_torch_recurrence_designs.py holds a model of both).
//
// Fragment layout (lane = 4 gr + tq). The accumulator holds rows gr and
// gr + 8, columns 2 tq and 2 tq + 1 of its 16 x 8 tile. Every operand is
// loaded with the contraction index permuted inside each k-step of 8: the
// lane's "k = tq" is the physical column 2 tq and its "k = tq + 4" is
// 2 tq + 1. Both operands of a product use the same permutation, so the sum
// is unchanged, and (1) an operand whose k is contiguous in shared memory is
// one 8-byte load per row, (2) an accumulator tile is already the A operand
// of the next product, with no shuffle.
#pragma once

#include "common.cuh"

namespace repro {
namespace chunk {

constexpr int CMAX = 64;           // longest chunk a block takes
constexpr int KMAX = 64;           // longest contraction width (dk; N)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// Inclusive prefix sums over CMAX positions held two per lane (positions
// lane and lane + 32): returns both prefixes and the total (the prefix at
// the last position; padding positions carry 0).
__device__ __forceinline__ void scan64(float a0, float a1, float& c0,
                                       float& c1, float& total) {
  c0 = warp_inclusive_scan(a0);
  c1 = warp_inclusive_scan(a1) + __shfl_sync(FULL, c0, 31);
  total = __shfl_sync(FULL, c1, 31);
}

// -- copies into the stage ring -------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past ``bytes`` (0..16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared, zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, CMAX) x columns [0, COLS) of a tile into shared memory (row pitch
// ``pitch`` elements): row i < rows comes from ``src + i * row_stride``,
// columns < cols from it and zeros past them; rows >= rows are zeros. With
// ``vec`` (the source and its row stride 16-byte aligned) 16-byte cp.async
// copies, else element copies (synchronous). NT threads share the work.
template <int NT, int COLS, typename T>
__device__ __forceinline__ void copy_tile(T* dst, int pitch, const T* src,
                                          long long row_stride, int rows,
                                          int cols, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);       // elements a copy
    constexpr int CH = (COLS + E - 1) / E;  // copies a row
    for (int idx = threadIdx.x; idx < CMAX * CH; idx += NT) {
      const int i = idx / CH, c = (idx % CH) * E;
      const int n = i < rows ? min(max(cols - c, 0), E) : 0;
      const T* s = n > 0 ? src + i * row_stride + c : src;
      cp_async16(dst + i * pitch + c, s, n * (int)sizeof(T));
    }
  } else {
    for (int idx = threadIdx.x; idx < CMAX * COLS; idx += NT) {
      const int i = idx / COLS, c = idx % COLS;
      dst[i * pitch + c] = i < rows && c < cols ? src[i * row_stride + c]
                                                : from_f32<T>(0.f);
    }
  }
}

inline bool aligned16(const void* p) {   // host side
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// -- 3xTF32 products on the tensor cores ------------------------------------------

// x = hi + lo: hi is x truncated to TF32 (its low 13 bits cleared) and lo =
// x - hi, exact in fp32. The tensor cores read the top 19 bits of a .tf32
// operand, so lo enters the products truncated to TF32 as well: two
// instructions an operand, and a product error of ~2^-20 relative (the CPU
// model of the split computes the same).
struct FragA {   // a 16 x 8 A operand, hi and lo parts
  unsigned hi[4], lo[4];
};
struct FragB {   // an 8 x 8 B operand
  unsigned hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(const float (&a)[4]) {
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], f.hi[e], f.lo[e]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to about fp32 accuracy: the two small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// c += a b where b is exactly a TF32 value (its lo part is 0: a bf16
// input widened to fp32), so its lo product is left out
__device__ __forceinline__ void mma2(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// c += a b for a B operand read from a tile of input type T
template <typename T>
__device__ __forceinline__ void mma_in(float (&c)[4], const FragA& a,
                                       const FragB& b) {
  if constexpr (sizeof(T) == 2) {
    mma2(c, a, b);
  } else {
    mma3(c, a, b);
  }
}

// -- operand loads from shared memory (k permuted as in the header) -----------

template <typename T>
__device__ __forceinline__ float2 ld_pair(const T* p);
template <>
__device__ __forceinline__ float2 ld_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 ld_pair<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A rows r0 .. r0 + 15 of a tile M[row][k], k-step k0 (one 8-byte load a row)
template <typename T>
__device__ __forceinline__ void ld_a_rows(const T* M, int pitch, int r0,
                                          int k0, float (&a)[4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const float2 u = ld_pair(M + (r0 + gr) * pitch + k0 + 2 * tq);
  const float2 v = ld_pair(M + (r0 + gr + 8) * pitch + k0 + 2 * tq);
  a[0] = u.x;
  a[1] = v.x;
  a[2] = u.y;
  a[3] = v.y;
}

// A rows r0 .. r0 + 15 of the transpose of a tile M[k][row]
template <typename T>
__device__ __forceinline__ void ld_a_cols(const T* M, int pitch, int r0,
                                          int k0, float (&a)[4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const T* p = M + (k0 + 2 * tq) * pitch + r0 + gr;
  a[0] = to_f32<T>(p[0]);
  a[1] = to_f32<T>(p[8]);
  a[2] = to_f32<T>(p[pitch]);
  a[3] = to_f32<T>(p[pitch + 8]);
}

// B columns n0 .. n0 + 7 as the transpose of a tile M[n][k]
template <typename T>
__device__ __forceinline__ FragB ld_b_rows(const T* M, int pitch, int n0,
                                           int k0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const float2 u = ld_pair(M + (n0 + gr) * pitch + k0 + 2 * tq);
  if constexpr (sizeof(T) == 2) {
    return FragB{{__float_as_uint(u.x), __float_as_uint(u.y)}, {0u, 0u}};
  } else {
    return frag_b(u.x, u.y);
  }
}

// B columns n0 .. n0 + 7 of a tile M[k][n] (a bf16 value is its own hi
// part: no split)
template <typename T>
__device__ __forceinline__ FragB ld_b_cols(const T* M, int pitch, int n0,
                                           int k0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const T* p = M + (k0 + 2 * tq) * pitch + n0 + gr;
  if constexpr (sizeof(T) == 2) {
    return FragB{{__float_as_uint(to_f32<T>(p[0])),
                  __float_as_uint(to_f32<T>(p[pitch]))}, {0u, 0u}};
  } else {
    return frag_b(to_f32<T>(p[0]), to_f32<T>(p[pitch]));
  }
}

// -- tiles split once into hi and lo parts ------------------------------------
// A tile that several warps read as an operand is stored as two float tiles
// of one layout, its hi and its lo parts, written once by its producer, so
// that the readers load fragments without splitting them again.

__device__ __forceinline__ void store_split(float* hi, float* lo, int at,
                                            float x) {
  unsigned h, l;
  split(x, h, l);
  hi[at] = __uint_as_float(h);
  lo[at] = __uint_as_float(l);
}
__device__ __forceinline__ void store_split2(float* hi, float* lo, int at,
                                             float x, float y) {
  unsigned h0, l0, h1, l1;
  split(x, h0, l0);
  split(y, h1, l1);
  *reinterpret_cast<float2*>(hi + at) =
      make_float2(__uint_as_float(h0), __uint_as_float(h1));
  *reinterpret_cast<float2*>(lo + at) =
      make_float2(__uint_as_float(l0), __uint_as_float(l1));
}

// A rows r0 .. r0 + 15 of a split tile M[row][k]
__device__ __forceinline__ FragA ld_a_rows_split(const float* hi,
                                                 const float* lo, int pitch,
                                                 int r0, int k0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int at = (r0 + gr) * pitch + k0 + 2 * tq, at8 = at + 8 * pitch;
  const float2 h0 = ld_pair(hi + at), h1 = ld_pair(hi + at8);
  const float2 l0 = ld_pair(lo + at), l1 = ld_pair(lo + at8);
  return FragA{{__float_as_uint(h0.x), __float_as_uint(h1.x),
                __float_as_uint(h0.y), __float_as_uint(h1.y)},
               {__float_as_uint(l0.x), __float_as_uint(l1.x),
                __float_as_uint(l0.y), __float_as_uint(l1.y)}};
}

// A rows r0 .. r0 + 15 of the transpose of a split tile M[k][row]
__device__ __forceinline__ FragA ld_a_cols_split(const float* hi,
                                                 const float* lo, int pitch,
                                                 int r0, int k0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int at = (k0 + 2 * tq) * pitch + r0 + gr;
  return FragA{{__float_as_uint(hi[at]), __float_as_uint(hi[at + 8]),
                __float_as_uint(hi[at + pitch]),
                __float_as_uint(hi[at + pitch + 8])},
               {__float_as_uint(lo[at]), __float_as_uint(lo[at + 8]),
                __float_as_uint(lo[at + pitch]),
                __float_as_uint(lo[at + pitch + 8])}};
}

// B columns n0 .. n0 + 7 as the transpose of a split tile M[n][k]
__device__ __forceinline__ FragB ld_b_rows_split(const float* hi,
                                                 const float* lo, int pitch,
                                                 int n0, int k0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int at = (n0 + gr) * pitch + k0 + 2 * tq;
  const float2 h = ld_pair(hi + at), l = ld_pair(lo + at);
  return FragB{{__float_as_uint(h.x), __float_as_uint(h.y)},
               {__float_as_uint(l.x), __float_as_uint(l.y)}};
}

// B columns n0 .. n0 + 7 of a split tile M[k][n]
__device__ __forceinline__ FragB ld_b_cols_split(const float* hi,
                                                 const float* lo, int pitch,
                                                 int n0, int k0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int at = (k0 + 2 * tq) * pitch + n0 + gr;
  return FragB{{__float_as_uint(hi[at]), __float_as_uint(hi[at + pitch])},
               {__float_as_uint(lo[at]), __float_as_uint(lo[at + pitch])}};
}

// cudaFuncSetAttribute for the dynamic shared memory of ``kern``, once per
// device (and so never inside a stream capture).
template <typename K>
inline int allow_smem(K kern, int bytes, bool* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return -1;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  return 0;
}

}  // namespace chunk
}  // namespace repro
