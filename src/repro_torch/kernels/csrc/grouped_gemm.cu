// Grouped GEMM for Hopper (sm_90a): the rows of x, sorted by expert, each
// multiplied by its expert's matrix, with the group sizes read on the card.
//
// Replaces lax.ragged_dot as src/repro/models/moe.py :: _local_moe calls it
// (three times a MoE layer: gate, up, down). That is an XLA primitive, not a
// Pallas kernel; the port's plain form of it loops torch.matmul over the
// groups after reading their sizes on the host, which costs one host
// synchronisation and a few hundred launches a layer and makes a decode step
// impossible to capture as a CUDA graph. This kernel computes the same
// function with the sizes left on the device:
//
//   x (C, K) rows grouped by expert, w (E, K, N), group_sizes (E,) int64
//   summing to at most C; out (C, N) in x's dtype, fp32 accumulation;
//   row r of group e is x[r] @ w[e]; rows past the last group are 0.
//
// What bounds it on this card: bytes. At decode a group holds a row or a few
// (a token picks an expert once, so a group has at most T rows), so each
// weight element read does at most T multiply-adds: far below the ~295
// operations per byte at which the tensor cores would be the limit. The
// floor is the bytes of the active experts' weights over HBM bandwidth.
//
// The design (simple first; tensor cores and a fused gate/up pass are later
// work):
//   * grid (N tiles, E + 1). Block (t, e) owns columns [t*NT, (t+1)*NT) of
//     group e's rows; block (t, E) writes the zeros of the rows past the last
//     group. A block sums group_sizes[0 .. e) itself (its group's first row)
//     and leaves at once when its group is empty, so a launch never waits
//     for the host;
//   * a block keeps up to 8 of its group's rows in registers while it walks
//     all of K, so at decode each active expert's weights are read once. A
//     larger group (prefill) walks K once per 8 rows. The row count of a
//     pass picks a compile-time tile of 1, 2, 4 or 8 rows;
//   * 8 warps split K (warp s takes k = s, s + 8, ...); within a warp the 32
//     lanes take neighbouring 16-byte vectors of a weight row (8 bf16 or 4
//     fp32 values), so a warp reads 512 contiguous bytes per k. x is read as
//     per-warp broadcasts;
//   * fp32 FMAs (no TF32 for fp32 inputs), and the 8 warps' partial sums are
//     added in a fixed tree through shared memory, so the result does not
//     depend on scheduling: eager calls and graph replays are bit-equal.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 8;           // rows a pass keeps in registers

template <typename T> struct Tile {
  static constexpr int VEC = 16 / sizeof(T);   // values per 16-byte load
  static constexpr int NT = 32 * VEC;          // columns a block owns
};

// Rows [row0, row0 + rows) of one group (rows <= R) times w_e's columns
// [c0, c0 + VEC) of this lane, K split over the warps, summed through `red`.
template <typename T, int R>
__device__ __forceinline__ void rows_pass(const T* __restrict__ x,
                                          const T* __restrict__ we,
                                          T* __restrict__ out, long long row0,
                                          int rows, int K, int N, int c0,
                                          bool col_ok, float* red) {
  constexpr int VEC = Tile<T>::VEC;
  constexpr int NT = Tile<T>::NT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* xr[R];
#pragma unroll
  for (int r = 0; r < R; ++r)   // rows past `rows` re-read the last one
    xr[r] = x + (row0 + (r < rows ? r : rows - 1)) * (long long)K;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
  if (col_ok) {
    const T* wp = we + c0;
#pragma unroll 4
    for (int k = warp; k < K; k += WARPS) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(wp + (long long)k * N));
      const T* wv = reinterpret_cast<const T*>(&raw);
      float xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = to_f32<T>(__ldg(xr[r] + k));
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float wj = to_f32<T>(wv[j]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][j] = fmaf(xv[r], wj, acc[r][j]);
      }
    }
  }
  // tree over the warps: 4+4, 2+2, 1+1 (a fixed order)
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
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      repro::Vec<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[r][j]);
      *reinterpret_cast<repro::Vec<T, VEC>*>(out + (row0 + r) * N + c0) = o;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const long long* __restrict__ group_sizes,
                    T* __restrict__ out, int C, int K, int N, int E) {
  constexpr int VEC = Tile<T>::VEC;
  constexpr int NT = Tile<T>::NT;
  __shared__ float red[(WARPS / 2) * MAX_ROWS * NT];
  __shared__ long long partial[WARPS];
  const int e = blockIdx.y;                 // E: the rows past the last group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the group's first row: the sum of the sizes before it, on the device
  long long before = 0;
  for (int i = threadIdx.x; i < e; i += THREADS) before += group_sizes[i];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    before += __shfl_down_sync(0xffffffffu, before, off);
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
    repro::Vec<T, VEC> z;
#pragma unroll
    for (int j = 0; j < VEC; ++j) z.v[j] = from_f32<T>(0.f);
    for (long long r = lo + warp; r < hi; r += WARPS)
      *reinterpret_cast<repro::Vec<T, VEC>*>(out + r * N + c0) = z;
    return;
  }
  const T* we = w + (long long)e * K * N;
  for (long long row0 = lo; row0 < hi; row0 += MAX_ROWS) {
    const int rows = (int)(hi - row0 < MAX_ROWS ? hi - row0 : MAX_ROWS);
    if (rows == 1)
      rows_pass<T, 1>(x, we, out, row0, rows, K, N, c0, col_ok, red);
    else if (rows == 2)
      rows_pass<T, 2>(x, we, out, row0, rows, K, N, c0, col_ok, red);
    else if (rows <= 4)
      rows_pass<T, 4>(x, we, out, row0, rows, K, N, c0, col_ok, red);
    else
      rows_pass<T, 8>(x, we, out, row0, rows, K, N, c0, col_ok, red);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* group_sizes, void* out,
           int C, int K, int N, int E, cudaStream_t stream) {
  constexpr int NT = Tile<T>::NT;
  if (N % Tile<T>::VEC != 0) return -1;
  dim3 grid((N + NT - 1) / NT, E + 1);
  grouped_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const long long*>(group_sizes), static_cast<T*>(out), C, K,
      N, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (C, K), w (E, K, N), group_sizes (E,) int64 on the device, out (C, N);
// all contiguous and 16-byte aligned. Returns 0, a CUDA error code, or -1
// for a configuration the kernel does not take.
extern "C" int repro_grouped_gemm(const void* x, const void* w,
                                  const void* group_sizes, void* out, int C,
                                  int K, int N, int E, int is_bf16,
                                  void* stream) {
  if (C < 0 || K <= 0 || N <= 0 || E <= 0 || E >= 65535) return -1;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, group_sizes, out, C, K, N, E, s)
                 : launch<float>(x, w, group_sizes, out, C, K, N, E, s);
}
