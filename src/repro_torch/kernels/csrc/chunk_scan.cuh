// Building blocks shared by the two chunk-parallel recurrence kernels
// (rwkv6_chunk.cu, ssd_chunk.cu). Plain CUDA C++, no PyTorch headers.
//
// Both kernels have one shape. A block owns one (batch row, head) and a slice
// of VB columns of the recurrent state and of the output, and walks the
// sequence chunk by chunk with the state slice held in shared memory in fp32
// (the TPU form's sequential chunk grid axis, whose state lived in VMEM
// scratch, becomes this loop). Per chunk of C <= 64 positions it needs:
//   * in-chunk prefix sums of log-decays (a warp scan, two rows per lane);
//   * a C x C score tile, the product of two [C][K] tiles (K <= 64);
//   * the readout  y = scores @ vs + qd @ st              (C x VB)
//   * the carry    st = diag(cl) st + kr^T @ vs           (K x VB)
// where the kernel fills qd, kd, kr, vs, cl and the score tile's masking and
// decays. All products are fp32 FMAs on the CUDA cores.
#pragma once

#include "common.cuh"

namespace repro {
namespace chunk {

// threads per block: 8 warps. A block's shared memory fills most of an SM,
// so the kernels declare one block per SM (__launch_bounds__(NT, 1)) and
// the compiler may give each thread up to 255 registers: left to its own
// choice it capped the SSD kernel at 64 and spilled.
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int CMAX = 64;           // longest chunk a block takes
constexpr int KMAX = 64;           // longest contraction width (dk; N)
constexpr int VB = 32;             // state / output columns a block owns
constexpr int KP = KMAX + 4;       // row pitch of the [C][K] tiles and of
constexpr int CP = CMAX + 4;       // the score tile: 16-byte rows for float4
constexpr int TP = CMAX + 1;       // pitch of the transposed [K][C] tiles
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of one block (~127 KB: dynamic, opted in once per device).
// Rows >= C and columns >= K or past the slice are zeroed once at the start
// and never written, so the fixed-size loops below read zeros there. The
// products read rows as float4 (one shared-memory wavefront brings four
// values to a whole warp); column walks (the WKV6 scan) go through the
// transposed tiles, whose odd pitch keeps them free of bank conflicts.
struct Smem {
  alignas(16) float qd[CMAX * KP];   // [C][K] left factor of scores, readout
  alignas(16) float kd[CMAX * KP];   // [C][K] right factor of the scores
  alignas(16) float kr[CMAX * KP];   // [C][K] left factor of the carry
  alignas(16) float vs[CMAX * VB];   // [C][VB] right factor of readout, carry
  alignas(16) float sc[CMAX * CP];   // [C][C] scores
  alignas(16) float st[KMAX * VB];   // [K][VB] the state slice
  alignas(16) float xr[CMAX * VB];   // [C][VB] raw x (SSD's D x term)
  float lw[KMAX * TP];     // [K][C] log w (WKV6)
  float cumT[KMAX * TP];   // [K][C] in-chunk prefix sums of log w (WKV6)
  float last[KMAX];        // per state row: prefix sum over the whole chunk
  float cl[KMAX];          // per state row: decay over the whole chunk
  float row[CMAX];         // per position: bonus (WKV6) / dt (SSD)
  float cum[CMAX];         // per position: cumulative log-decay (SSD)
  float cum_last;
};

__device__ __forceinline__ Smem& smem() {
  extern __shared__ float4 smem_raw[];
  return *reinterpret_cast<Smem*>(smem_raw);
}

__device__ __forceinline__ void zero_smem(Smem& s) {
  float* all = reinterpret_cast<float*>(&s);
  for (int i = threadIdx.x; i < (int)(sizeof(Smem) / sizeof(float)); i += NT)
    all[i] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[a][b] = sum_{kk<K} L[i][kk] * R[j][kk] for i = ty + 16a, j = tx + 16b on
// a 16 x 16 thread grid: each float4 read feeds sixteen FMAs. Columns past
// K are zero, so K is rounded up to a multiple of 4.
__device__ __forceinline__ void score_tile(const float* L, const float* R,
                                           int K, float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int kk = 0; kk < K; kk += 4) {
    float4 lv[4], rv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) lv[a] = ld4(&L[(ty + 16 * a) * KP + kk]);
#pragma unroll
    for (int b = 0; b < 4; ++b) rv[b] = ld4(&R[(tx + 16 * b) * KP + kk]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = dot4(acc[a][b], lv[a], rv[b]);
  }
}

// out[a] = sum_{l<C} sc[i][l] vs[l][lane] + sum_{kk<K} qd[i][kk] st[kk][lane]
// for rows i = warp + 8a: the row is uniform over the warp (float4
// broadcasts), the lane is the column. Past C and K the tiles hold zeros.
__device__ __forceinline__ void readout(const Smem& s, int C, int K,
                                        float out[8]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < 8; ++a) out[a] = 0.f;
  for (int l = 0; l < C; l += 4) {
    const float4 v = make_float4(s.vs[l * VB + lane], s.vs[(l + 1) * VB + lane],
                                 s.vs[(l + 2) * VB + lane],
                                 s.vs[(l + 3) * VB + lane]);
#pragma unroll
    for (int a = 0; a < 8; ++a)
      out[a] = dot4(out[a], ld4(&s.sc[(warp + 8 * a) * CP + l]), v);
  }
  for (int kk = 0; kk < K; kk += 4) {
    const float4 v = make_float4(
        s.st[kk * VB + lane], s.st[(kk + 1) * VB + lane],
        s.st[(kk + 2) * VB + lane], s.st[(kk + 3) * VB + lane]);
#pragma unroll
    for (int a = 0; a < 8; ++a)
      out[a] = dot4(out[a], ld4(&s.qd[(warp + 8 * a) * KP + kk]), v);
  }
}

// st[kk][lane] = cl[kk] st[kk][lane] + sum_{i<C} kr[i][kk] vs[i][lane] for
// state rows kk = 8 warp + a < K (two float4 broadcasts of kr per position).
// Each thread writes only its own entries.
__device__ __forceinline__ void carry(Smem& s, int C, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) acc[a] = 0.f;
  for (int i = 0; i < C; ++i) {
    const float v = s.vs[i * VB + lane];
    const float4 k0 = ld4(&s.kr[i * KP + 8 * warp]);
    const float4 k1 = ld4(&s.kr[i * KP + 8 * warp + 4]);
    acc[0] = fmaf(k0.x, v, acc[0]);
    acc[1] = fmaf(k0.y, v, acc[1]);
    acc[2] = fmaf(k0.z, v, acc[2]);
    acc[3] = fmaf(k0.w, v, acc[3]);
    acc[4] = fmaf(k1.x, v, acc[4]);
    acc[5] = fmaf(k1.y, v, acc[5]);
    acc[6] = fmaf(k1.z, v, acc[6]);
    acc[7] = fmaf(k1.w, v, acc[7]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int kk = 8 * warp + a;
    if (kk < K) {
      float& st = s.st[kk * VB + lane];
      st = s.cl[kk] * st + acc[a];
    }
  }
}

// cudaFuncSetAttribute for the dynamic shared memory of ``kern``, once per
// device (and so never inside a stream capture).
template <typename K>
inline int allow_smem(K kern, bool* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return -1;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  return 0;
}

}  // namespace chunk
}  // namespace repro
