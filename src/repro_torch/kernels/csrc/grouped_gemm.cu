// Grouped GEMM for Hopper (sm_90a): the rows of x, sorted by expert, each
// multiplied by its expert's matrix, with the group sizes read on the card;
// and the fused gate/up pass of the MoE's expert FFN built the same way.
//
// Replaces lax.ragged_dot as src/repro/models/moe.py :: _local_moe calls it
// (:128-132: gate, up and down, then silu(g) * u between them). That is an
// XLA primitive, not a Pallas kernel; the port's plain form of it loops
// torch.matmul over the groups after reading their sizes on the host, which
// costs one host synchronisation and a few hundred launches a layer and makes
// a decode step impossible to capture as a CUDA graph. These kernels compute
// the same functions with the sizes left on the device:
//
//   repro_grouped_gemm:   x (C, K) rows grouped by expert, w (E, K, N),
//       group_sizes (E,) int64 summing to at most C; out (C, N) in x's dtype,
//       fp32 accumulation; row r of group e is x[r] @ w[e]; rows past the
//       last group are 0.
//   repro_grouped_swiglu: the same rows against w_gate and w_up, both
//       (E, K, N): out = silu(g) * u, where g and u are each rounded to x's
//       dtype first (lax.ragged_dot returns x's dtype), the product is taken
//       in fp32 and rounded once. g and u never leave the block.
//
// What bounds them on this card: bytes. At decode a group holds a row or a
// few (a token picks an expert once), so a weight element read does at most
// a few multiply-adds; at arctic's 512-row prefill ~4 (35.7 GFLOP against
// 8.9 GB: 14 TFLOP/s at the byte bound, a few per cent of the tensor cores).
// The floor is the bytes of the active experts' weights over HBM bandwidth,
// so the design is a weight stream with enough bytes in flight.
//
// bf16 (the serving path):
//   * a persistent grid, two blocks per SM (the wrapper passes the SM
//     count). Each block scans group_sizes into shared memory (a warp scan
//     over E): every group's first row and first work item. A work item is
//     (non-empty group, 128-column tile of N, chunk of up to 32 of the
//     group's rows);
//     a block takes items blockIdx.x, blockIdx.x + gridDim.x, ... and finds
//     each one's group by a binary search over the first items (an empty
//     group owns none). Rows past the last group are zeroed by the same
//     launch, split over the blocks;
//   * the weights are streamed, not loaded by the computing threads: every
//     thread issues 16-byte cp.async copies of a stage (a 128 x 128 slab of
//     w[e], or 64 x 128 of each of the fused pass's two matrices: 32 KB of
//     weights, and the item's rows of x beside them) into a ring of two
//     stages, one in flight while the other computes: 64 KB of weights in
//     flight per SM over its two blocks. On the card the stage's size, not
//     the ring's depth, set the rate: a block pays a barrier and a wait for
//     its slowest copy per stage, so 32 KB stages ran closer to the byte
//     bound than deeper rings of 16 KB or 8 KB ones, and a second block per
//     SM copies while the first waits. The ring runs on across items, so the
//     next item's first stage loads while this one's last one computes;
//   * the product runs on the tensor cores: mma.sync.m16n8k16, bf16 in,
//     fp32 accumulators, with the operands swapped: out^T = w^T x^T. The
//     tile's 128 columns are the M side (16 a warp, ldmatrix.trans on the
//     N-contiguous slab), the group's rows the n = 8 side (ldmatrix on the
//     K-contiguous rows of x), so a decode group of 1-2 rows wastes
//     tensor-core lanes, which cost nothing here, and no FMA issue slots. An
//     item of up to 32 rows keeps 4 n-tiles of accumulators and runs them
//     all on each slab while it is in shared memory, so each weight element
//     is read from device memory once per 32 rows of its group; the chunks
//     of a larger group are consecutive items, taken at the same time by
//     neighbouring blocks, whose later reads of a slab hit L2. mma.sync
//     rather than wgmma: the kernel is byte-bound at every shape the MoE
//     gives it and mma.sync's rate is many times what the bytes allow;
//     wgmma would add a warpgroup-wide 64-column tile and a swizzled
//     shared-memory layout for both operands, for no gain while HBM sets
//     the rate;
//   * a decode step's few active experts can leave the grid's last round
//     mostly empty (14 experts x 38 tiles = 532 items for 264 blocks: a
//     third round for 4 of them). K is then cut into up to 4 parts, the cut
//     that fills the rounds best, chosen on the device from the work list;
//     each part's fp32 sums go to scratch, and a second kernel adds the
//     parts in part order and runs the epilogue;
//   * the epilogue stages the item's (rows x 128) tile in shared memory and
//     writes it as 16-byte rows (the fused pass computes silu(g) * u there);
//   * K of any size (slabs past K read zeros); x rows move as 16-byte copies
//     when K is a multiple of 8 and x is aligned, else element by element.
//
// fp32: the first design, kept, on FP32 FMAs (no TF32: fp32 stays exact
// fp32): a block per (128-column tile, group), up to 8 rows in registers,
// the 8 warps' sums added in a fixed tree; the fused pass keeps both
// matrices' sums in the same pass over x.
//
// Every order of summation is fixed (each output element is summed over K,
// or over a part of K, by one warp in stage order, the parts by the second
// pass in part order; fp32 by the fixed tree): no atomics, so eager calls
// and graph replays are bit-equal.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;
using bf16 = __nv_bfloat16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;     // a block's dynamic shared memory, at most

// silu(g) * u as the reference computes h: g and u rounded to T first
template <typename T>
__device__ __forceinline__ float swiglu(float g, float u) {
  g = to_f32<T>(from_f32<T>(g));
  u = to_f32<T>(from_f32<T>(u));
  return g / (1.f + expf(-g)) * u;
}

// Above 48 KB a block's shared memory is dynamic and must be asked for, once
// per device (and outside any stream capture, hence remembered).
template <typename Kern>
int allow_smem(Kern kern, int bytes, bool (&configured)[64]) {
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

// -- fp32: FMAs --------------------------------------------------------------

namespace fma {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 8;           // rows a pass keeps in registers
constexpr int VEC = 4;                // fp32 values per 16-byte load
constexpr int NT = 32 * VEC;          // columns a block owns

// Adds the 8 warps' partial sums in a fixed tree (4+4, 2+2, 1+1) through
// `red`; warp 0 ends with the totals.
template <int R>
__device__ __forceinline__ void tree_sum(float (&acc)[R][VEC], float* red,
                                         int warp, int lane) {
#pragma unroll
  for (int half = WARPS / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
      float* dst = red + (warp - half) * R * NT + lane * VEC;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < VEC; ++j) dst[r * NT + j] = acc[r][j];
    }
    __syncthreads();
    if (warp < half) {
      const float* src = red + warp * R * NT + lane * VEC;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[r][j] += src[r * NT + j];
    }
    __syncthreads();
  }
}

// Rows [row0, row0 + rows) of one group (rows <= R) times the columns
// [c0, c0 + VEC) of this lane of w_e (and, with DUAL, of w2_e), K split over
// the warps (warp s takes k = s, s + 8, ...).
template <int R, bool DUAL>
__device__ __forceinline__ void rows_pass(const float* __restrict__ x,
                                          const float* __restrict__ we,
                                          const float* __restrict__ we2,
                                          float* __restrict__ out,
                                          long long row0, int rows, int K,
                                          int N, int c0, bool col_ok,
                                          float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xr[R];
#pragma unroll
  for (int r = 0; r < R; ++r)   // rows past `rows` re-read the last one
    xr[r] = x + (row0 + (r < rows ? r : rows - 1)) * (long long)K;
  float acc[R][VEC], acc2[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = acc2[r][j] = 0.f;
  if (col_ok) {
#pragma unroll 4
    for (int k = warp; k < K; k += WARPS) {
      const float4 wv =
          __ldg(reinterpret_cast<const float4*>(we + (long long)k * N + c0));
      float4 wv2 = wv;
      if constexpr (DUAL)
        wv2 = __ldg(
            reinterpret_cast<const float4*>(we2 + (long long)k * N + c0));
      const float w1[VEC] = {wv.x, wv.y, wv.z, wv.w};
      const float w2[VEC] = {wv2.x, wv2.y, wv2.z, wv2.w};
      float xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = __ldg(xr[r] + k);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][j] = fmaf(xv[r], w1[j], acc[r][j]);
          if constexpr (DUAL) acc2[r][j] = fmaf(xv[r], w2[j], acc2[r][j]);
        }
    }
  }
  tree_sum<R>(acc, red, warp, lane);
  if constexpr (DUAL) tree_sum<R>(acc2, red, warp, lane);
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      float4 o;
      float* ov = reinterpret_cast<float*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        ov[j] = DUAL ? swiglu<float>(acc[r][j], acc2[r][j]) : acc[r][j];
      *reinterpret_cast<float4*>(out + (row0 + r) * N + c0) = o;
    }
  }
}

// grid (N tiles, E + 1): block (t, e) owns columns [t*NT, (t+1)*NT) of group
// e's rows; block (t, E) writes the zeros of the rows past the last group. A
// block sums group_sizes[0 .. e) itself and leaves at once when its group is
// empty. A group walks K once per 8 rows.
template <bool DUAL>
__global__ void __launch_bounds__(THREADS)
grouped_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ w2,
                   const long long* __restrict__ group_sizes,
                   float* __restrict__ out, int C, int K, int N, int E) {
  __shared__ float red[(WARPS / 2) * MAX_ROWS * NT];
  __shared__ long long partial[WARPS];
  const int e = blockIdx.y;                 // E: the rows past the last group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  long long before = 0;
  for (int i = threadIdx.x; i < e; i += THREADS) before += group_sizes[i];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    before += __shfl_down_sync(FULL, before, off);
  if (lane == 0) partial[warp] = before;
  __syncthreads();
  long long start = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) start += partial[i];
  const long long lo = start < C ? start : C;
  long long hi = C;
  if (e < E) {
    const long long end = start + group_sizes[e];
    hi = end < C ? end : C;
  }
  if (hi <= lo) return;                     // the same for the whole block

  const int c0 = blockIdx.x * NT + lane * VEC;
  const bool col_ok = c0 < N;               // N is a multiple of VEC
  if (e == E) {                             // rows past the last group: zeros
    if (!col_ok) return;
    for (long long r = lo + warp; r < hi; r += WARPS)
      *reinterpret_cast<float4*>(out + r * N + c0) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float* we = w + (long long)e * K * N;
  const float* we2 = DUAL ? w2 + (long long)e * K * N : nullptr;
  for (long long row0 = lo; row0 < hi; row0 += MAX_ROWS) {
    const int rows = (int)(hi - row0 < MAX_ROWS ? hi - row0 : MAX_ROWS);
    if (rows == 1)
      rows_pass<1, DUAL>(x, we, we2, out, row0, rows, K, N, c0, col_ok, red);
    else if (rows == 2)
      rows_pass<2, DUAL>(x, we, we2, out, row0, rows, K, N, c0, col_ok, red);
    else if (rows <= 4)
      rows_pass<4, DUAL>(x, we, we2, out, row0, rows, K, N, c0, col_ok, red);
    else
      rows_pass<8, DUAL>(x, we, we2, out, row0, rows, K, N, c0, col_ok, red);
  }
}

template <bool DUAL>
int launch(const void* x, const void* w, const void* w2,
           const void* group_sizes, void* out, int C, int K, int N, int E,
           cudaStream_t stream) {
  if (N % VEC != 0 || E >= 65535) return -1;
  dim3 grid((N + NT - 1) / NT, E + 1);
  grouped_fma_kernel<DUAL><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(w2),
      static_cast<const long long*>(group_sizes), static_cast<float*>(out), C,
      K, N, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma

// -- bf16: tensor cores, a persistent grid, a cp.async weight stream ---------

namespace tc {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NT = 16 * WARPS;     // columns an item owns (the mma's M side)
constexpr int RP = 32;             // rows of x an item holds: 4 n-tiles of 8
constexpr int STAGES = 2;          // the ring: one stage in flight
constexpr int BPS = 2;             // blocks an SM runs
constexpr int LDW = NT + 8;        // padded rows: the 8 rows an ldmatrix
constexpr int LDO = NT + 8;        // phase reads fall in 8 distinct 16-byte
                                   // bank groups

// A stage holds NMAT slabs of BK x NT weights (matrix m) and the item's rows
// of x over the same BK.
template <int NMAT_, int BK_> struct Cfg {
  static constexpr int NMAT = NMAT_, BK = BK_;
  static constexpr int LDX = BK + 8;
  static constexpr int W_ELEMS = BK * LDW;
  static constexpr int STAGE = NMAT * W_ELEMS + RP * LDX;   // bf16 elements
  // ring, the epilogue's tile, then each group's first row and first item
  static size_t smem_bytes(int E) {
    return ((size_t)STAGES * STAGE + (size_t)RP * LDO) * sizeof(bf16) +
           (size_t)(2 * E + 2) * sizeof(int);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, past L1, with L2 asked to
// fetch the whole 128-byte line; zeros when !valid (source size 0: nothing
// is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(valid ? 16 : 0)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and register i holds this lane's pair of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Item {
  int e;       // expert
  int row0;    // first row of x (and of out)
  int rows;    // 1 .. RP
  int n0;      // first column
  int part;    // which of the `split` parts of K
  int ks0;     // first stage of K
  int len;     // stages of K
};

// Item `item` of a list where every (group, column tile, row chunk) is cut
// into `split` parts of K. The group is the last g whose first item is <=
// item / split (an empty group shares its first item with the next one,
// and the search passes it); a group's items run over its column tiles,
// within a tile over its chunks of RP rows, within a chunk over its parts.
__device__ __forceinline__ Item find_item(int item, int split, int KS,
                                          const int* start, const int* first,
                                          int E) {
  const int j = item / split, p = item - j * split;
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= j)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int rows = start[lo + 1] - start[lo];
  const int chunks = (rows + RP - 1) / RP;
  const int local = j - first[lo];
  const int t = local / chunks, c = local - t * chunks;
  Item it;
  it.e = lo;
  it.row0 = start[lo] + c * RP;
  it.rows = min(RP, rows - c * RP);
  it.n0 = t * NT;
  it.part = p;
  it.ks0 = p * KS / split;
  it.len = (p + 1) * KS / split - it.ks0;
  return it;
}

// The share of the grid's slots that `items` fill over the rounds they take
__device__ __forceinline__ float fill(int items, int grid) {
  return (float)items / (float)(((items + grid - 1) / grid) * grid);
}

// One stage: acc[m][t] (this warp's 16 columns x the 8 rows of n-tile t)
// += the stage's BK k of matrix m. Fragments (lane = 4 gr + tq):
// a holds w^T rows (columns of w) gr, gr + 8 and k 2tq, 2tq + 1, +8, +9,
// loaded transposed from the N-contiguous slab; b holds k 2tq, 2tq + 1 (+8)
// of row gr of x, from its K-contiguous rows; acc holds columns gr, gr + 8
// and rows 2tq, 2tq + 1 of the n-tile.
template <typename G, int NTL>
__device__ __forceinline__ void stage_mma(float (&acc)[G::NMAT][RP / 8][4],
                                          const bf16* st, int warp, int lane) {
  const bf16* xs = st + G::NMAT * G::W_ELEMS;
  const int r8 = (lane & 7) + ((lane >> 4) << 3);   // row within 16
  const int h8 = ((lane >> 3) & 1) * 8;             // which half of 16
#pragma unroll
  for (int kk = 0; kk < G::BK / 16; ++kk) {
    unsigned b[(NTL + 1) / 2][4];
#pragma unroll
    for (int p = 0; p < (NTL + 1) / 2; ++p)
      ldmatrix_x4(b[p], xs + (p * 16 + r8) * G::LDX + kk * 16 + h8);
#pragma unroll
    for (int m = 0; m < G::NMAT; ++m) {
      unsigned a[4];
      ldmatrix_x4_trans(a, st + m * G::W_ELEMS + (kk * 16 + r8) * LDW +
                               warp * 16 + h8);
#pragma unroll
      for (int t = 0; t < NTL; ++t)
        mma_bf16(acc[m][t], a, b[t >> 1][(t & 1) * 2],
                 b[t >> 1][(t & 1) * 2 + 1]);
    }
  }
}

// The item's tile through shared memory into out, 16 bytes a thread; or,
// when K is split, its fp32 sums into plane (m, part) of `partial`, which
// the second pass adds up.
template <int NMAT>
__device__ __forceinline__ void epilogue(const float (&acc)[NMAT][RP / 8][4],
                                         const Item& it, bf16* ostage,
                                         bf16* __restrict__ out,
                                         float* __restrict__ partial,
                                         int split, int C, int N, int warp,
                                         int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  if (split > 1) {
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      float* pl = partial + (long long)(m * split + it.part) * C * N;
#pragma unroll
      for (int t = 0; t < RP / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = t * 8 + 2 * tq + (i & 1);
          const int n = it.n0 + warp * 16 + gr + (i >> 1) * 8;
          if (r < it.rows && n < N)
            pl[(long long)(it.row0 + r) * N + n] = acc[m][t][i];
        }
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < RP / 8; ++t) {
    if (t * 8 >= it.rows) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[0][t][i];
      if constexpr (NMAT == 2) v = swiglu<bf16>(acc[0][t][i], acc[1][t][i]);
      ostage[(t * 8 + 2 * tq + (i & 1)) * LDO + warp * 16 + gr +
             (i >> 1) * 8] = __float2bfloat16(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < RP * NT / 8; c += THREADS) {
    const int r = c / (NT / 8), n = it.n0 + (c % (NT / 8)) * 8;
    if (r < it.rows && n < N)
      *reinterpret_cast<uint4*>(out + (long long)(it.row0 + r) * N + n) =
          *reinterpret_cast<const uint4*>(ostage + r * LDO + n - it.n0);
  }
}

template <typename G>
__global__ void __launch_bounds__(THREADS, BPS)
grouped_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                  const bf16* __restrict__ w1,
                  const long long* __restrict__ group_sizes,
                  bf16* __restrict__ out, float* __restrict__ partial,
                  int* __restrict__ info, int C, int K, int N, int E,
                  int x_vec, int max_split) {
  constexpr int S = STAGES, BK = G::BK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* ostage = ring + S * G::STAGE;
  int* start = reinterpret_cast<int*>(ostage + RP * LDO);   // E + 1
  int* first = start + E + 1;                                // E + 1
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (N + NT - 1) / NT;
  const int KS = (K + BK - 1) / BK;

  // 1. the work list: each group's first row (clamped to C) and first item,
  // by warp 0 in scans of 32 groups
  if (warp == 0) {
    long long rows_before = 0;
    int items_before = 0;
    for (int g0 = 0; g0 < E; g0 += 32) {
      const int g = g0 + lane;
      const long long n = g < E ? max(group_sizes[g], 0LL) : 0LL;
      long long incl = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      const long long s0 = rows_before + incl - n;
      const int lo = (int)min(s0, (long long)C);
      const int hi = (int)min(s0 + n, (long long)C);
      const int cnt = hi > lo ? n_tiles * ((hi - lo + RP - 1) / RP) : 0;
      int icl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, icl, off);
        if (lane >= off) icl += v;
      }
      if (g < E) {
        start[g] = lo;
        first[g] = items_before + icl - cnt;
      }
      rows_before += __shfl_sync(FULL, incl, 31);
      items_before += __shfl_sync(FULL, icl, 31);
    }
    if (lane == 0) {
      start[E] = (int)min(rows_before, (long long)C);
      first[E] = items_before;
    }
  }
  __syncthreads();
  const int tail = start[E];
  const int grid = gridDim.x;
  // K is cut into `split` parts when that fills the grid's last round
  // better (a decode step's few active experts); the choice reads only the
  // work list, so every block makes the same one
  const int whole = first[E];
  int split = 1;
  if (whole > 0) {
    float best = fill(whole, grid);
    for (int c = 2; c <= min(max_split, KS); ++c)
      if (fill(whole * c, grid) > best + 0.02f) {
        best = fill(whole * c, grid);
        split = c;
      }
  }
  if (blockIdx.x == 0 && tid == 0) {   // for the second pass
    info[0] = split;
    info[1] = tail;
  }
  const int n_items = whole * split;

  // 2. rows past the last group: zeros, split over the grid
  {
    const int vecs = N / 8;
    const long long total = (long long)(C - tail) * vecs;
    for (long long i = (long long)blockIdx.x * THREADS + tid; i < total;
         i += (long long)grid * THREADS)
      *reinterpret_cast<uint4*>(out + (tail + i / vecs) * N +
                                (i % vecs) * 8) = make_uint4(0, 0, 0, 0);
  }

  // 3. this block's items (blockIdx.x, + grid, ...) as one stream of stages
  const int mine = (int)blockIdx.x < n_items
                       ? (n_items - 1 - (int)blockIdx.x) / grid + 1
                       : 0;
  if (mine == 0) return;   // the same for the whole block
  int total_q = 0;
  for (int m = 0; m < mine; ++m) {
    const int p = (blockIdx.x + m * grid) % split;
    total_q += (p + 1) * KS / split - p * KS / split;
  }

  // the item whose stages are being issued, its index and next stage
  Item ld = find_item(blockIdx.x, split, KS, start, first, E);
  int ld_m = 0, ld_s = 0;
  // issue stage q of the stream into slot q % S (one commit group a stage,
  // empty past the stream's end)
  auto issue = [&](int q) {
    if (q < total_q) {
      bf16* st = ring + (q % S) * G::STAGE;
      const int k0 = (ld.ks0 + ld_s) * BK;
#pragma unroll
      for (int m = 0; m < G::NMAT; ++m) {
        const bf16* we = (m == 0 ? w0 : w1) + (long long)ld.e * K * N;
#pragma unroll
        for (int i = 0; i < BK * NT / 8 / THREADS; ++i) {
          const int c = tid + i * THREADS;
          const int kr = c / (NT / 8), cc = c % (NT / 8);
          const int k = k0 + kr, n = ld.n0 + cc * 8;
          const bool ok = k < K && n < N;
          cp_async16(st + m * G::W_ELEMS + kr * LDW + cc * 8,
                     ok ? we + (long long)k * N + n : we, ok);
        }
      }
      bf16* xs = st + G::NMAT * G::W_ELEMS;
      if (x_vec) {
        for (int c = tid; c < RP * BK / 8; c += THREADS) {
          const int r = c / (BK / 8), k = k0 + (c % (BK / 8)) * 8;
          if (r < ld.rows)
            cp_async16(xs + r * G::LDX + k - k0,
                       k < K ? x + (long long)(ld.row0 + r) * K + k : x,
                       k < K);
        }
      } else {   // rows not 16-byte aligned: element copies
        for (int c = tid; c < RP * BK; c += THREADS) {
          const int r = c / BK, k = k0 + c % BK;
          if (r < ld.rows)
            xs[r * G::LDX + k - k0] =
                k < K ? x[(long long)(ld.row0 + r) * K + k]
                      : __float2bfloat16(0.f);
        }
      }
      if (++ld_s == ld.len) {
        ld_s = 0;
        if (++ld_m < mine)
          ld = find_item(blockIdx.x + ld_m * grid, split, KS, start, first,
                         E);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue(q);
  float acc[G::NMAT][RP / 8][4];
  Item cur = find_item(blockIdx.x, split, KS, start, first, E);
  int cur_m = 0, cur_s = 0;
  for (int q = 0; q < total_q; ++q) {
    cp_async_wait<S - 2>();   // stage q has landed (this thread's copies)
    __syncthreads();          // ... everyone's; slot (q - 1) % S is free
    issue(q + S - 1);
    if (cur_s == 0) {
#pragma unroll
      for (int m = 0; m < G::NMAT; ++m)
#pragma unroll
        for (int t = 0; t < RP / 8; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][t][i] = 0.f;
    }
    const bf16* st = ring + (q % S) * G::STAGE;
    if (cur.rows <= 8)
      stage_mma<G, 1>(acc, st, warp, lane);
    else if (cur.rows <= 16)
      stage_mma<G, 2>(acc, st, warp, lane);
    else
      stage_mma<G, 4>(acc, st, warp, lane);
    if (++cur_s == cur.len) {
      epilogue<G::NMAT>(acc, cur, ostage, out, partial, split, C, N, warp,
                        lane);
      cur_s = 0;
      if (++cur_m < mine)
        cur = find_item(blockIdx.x + cur_m * grid, split, KS, start, first,
                        E);
    }
  }
  cp_async_wait<0>();
}

// The second pass of a split K: out = the parts' fp32 sums added in part
// order (and the fused pass's epilogue), for the rows of the groups; a no-op
// when the first pass did not split.
template <int NMAT>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ partial, const int* __restrict__ info,
               bf16* __restrict__ out, int C, int N) {
  const int split = info[0], tail = info[1];
  if (split <= 1) return;
  const long long plane = (long long)C * N;
  const long long total = (long long)tail * N / 4;
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < total;
       v += (long long)gridDim.x * THREADS) {
    float4 a[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      const float4* pm =
          reinterpret_cast<const float4*>(partial + m * split * plane) + v;
      a[m] = pm[0];
      for (int p = 1; p < split; ++p) {
        const float4 b = pm[p * plane / 4];
        a[m].x += b.x;
        a[m].y += b.y;
        a[m].z += b.z;
        a[m].w += b.w;
      }
    }
    float r[4] = {a[0].x, a[0].y, a[0].z, a[0].w};
    if constexpr (NMAT == 2) {
      r[0] = swiglu<bf16>(a[0].x, a[1].x);
      r[1] = swiglu<bf16>(a[0].y, a[1].y);
      r[2] = swiglu<bf16>(a[0].z, a[1].z);
      r[3] = swiglu<bf16>(a[0].w, a[1].w);
    }
    uint2 o;
    *reinterpret_cast<__nv_bfloat162*>(&o.x) =
        __floats2bfloat162_rn(r[0], r[1]);
    *reinterpret_cast<__nv_bfloat162*>(&o.y) =
        __floats2bfloat162_rn(r[2], r[3]);
    reinterpret_cast<uint2*>(out)[v] = o;
  }
}

template <typename G>
int launch(const void* x, const void* w0, const void* w1,
           const void* group_sizes, void* out, void* partial, void* info,
           int max_split, int C, int K, int N, int E, int sms,
           cudaStream_t stream) {
  if (N % 8 != 0 || sms <= 0 || max_split < 1) return -1;
  const size_t bytes = G::smem_bytes(E);
  if (bytes > (size_t)MAX_SMEM) return -1;
  auto kern = grouped_tc_kernel<G>;
  static bool configured[64] = {};
  const int err = allow_smem(kern, MAX_SMEM, configured);
  if (err) return err;
  const int x_vec =
      K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 1 : 0;
  kern<<<BPS * sms, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w1),
      static_cast<const long long*>(group_sizes), static_cast<bf16*>(out),
      static_cast<float*>(partial), static_cast<int*>(info), C, K, N, E,
      x_vec, max_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || max_split == 1) return static_cast<int>(e);
  const long long need = ((long long)C * N / 4 + THREADS - 1) / THREADS;
  const int blocks = need < BPS * sms ? (int)need : BPS * sms;
  combine_kernel<G::NMAT><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const int*>(info),
      static_cast<bf16*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

// the entry points' stages: 32 KB of weights each
using GemmCfg = Cfg<1, 128>;     // one matrix, 128 k a stage
using SwigluCfg = Cfg<2, 64>;    // gate and up, 64 k each

}  // namespace tc

}  // namespace

// x (C, K), w (E, K, N), group_sizes (E,) int64 on the device, out (C, N);
// all contiguous, w and out 16-byte aligned. `sms` is the device's SM count
// (the bf16 kernel's persistent grid); bf16 only: `info` two ints of scratch
// and `partial` max_split x C x N fp32 of it (max_split 1: K is never split
// and `partial` is not read). Returns 0, a CUDA error code, or -1 for a
// configuration the kernel does not take.
extern "C" int repro_grouped_gemm(const void* x, const void* w,
                                  const void* group_sizes, void* out,
                                  void* partial, void* info, int max_split,
                                  int C, int K, int N, int E, int is_bf16,
                                  int sms, void* stream) {
  if (C < 0 || K <= 0 || N <= 0 || E <= 0) return -1;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? tc::launch<tc::GemmCfg>(x, w, nullptr, group_sizes, out,
                                           partial, info, max_split, C, K, N,
                                           E, sms, s)
                 : fma::launch<false>(x, w, nullptr, group_sizes, out, C, K,
                                      N, E, s);
}

// The fused gate/up pass: out = silu(x @ w_gate[e]) * (x @ w_up[e]) per
// group, each product rounded to x's dtype before the epilogue; w_gate and
// w_up (E, K, N), the rest as repro_grouped_gemm.
extern "C" int repro_grouped_swiglu(const void* x, const void* w_gate,
                                    const void* w_up, const void* group_sizes,
                                    void* out, void* partial, void* info,
                                    int max_split, int C, int K, int N, int E,
                                    int is_bf16, int sms, void* stream) {
  if (C < 0 || K <= 0 || N <= 0 || E <= 0) return -1;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? tc::launch<tc::SwigluCfg>(x, w_gate, w_up, group_sizes,
                                             out, partial, info, max_split, C,
                                             K, N, E, sms, s)
                 : fma::launch<true>(x, w_gate, w_up, group_sizes, out, C, K,
                                     N, E, s);
}
