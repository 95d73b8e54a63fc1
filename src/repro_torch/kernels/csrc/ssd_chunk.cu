// Chunk-parallel Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py :: ssd_pallas (body
// _ssd_kernel). Same function: per head, with a scalar decay a_t =
// exp(dt_t A) and a (P x N) state h,
//     h_t = a_t h_{t-1} + (dt_t x_t) B_t^T,   y_t = h_t C_t + D x_t
// evaluated chunk by chunk in the matmul form of kernels/chunked.py (cum =
// in-chunk inclusive prefix sums of dt A; scores = (C B^T) * exp(clip(cum_i -
// cum_j, -60, 0)) on j <= i; y = scores (x dt) + (C exp(cum)) h^T + D x;
// h <- exp(cum_C) h + (x dt)^T (B exp(cum_C - cum))). Returns y and the final
// state in fp32; every exp and prefix sum is fp32 whatever the input dtype.
//
// What bounds it on this card: operations, as for rwkv6_chunk.cu: per chunk
// and head four C x 64 x 64-sized products (~2 MFLOP at C = P = N = 64) on
// O(C * (P + 2N)) input bytes, run as fp32 FMAs on the CUDA cores.
//
// What the design does about that (shared with rwkv6_chunk.cu,
// chunk_scan.cuh):
//   * the sequential chunk axis is a loop inside the block; the state slice
//     lives in shared memory, transposed to (N x VB) so that the readout and
//     the carry are the same products as WKV6's;
//   * a block owns one (batch row, head) and VB = 32 of the P columns, so
//     zamba2-2.7b's 80 heads at batch 1 give 160 blocks for 132 SMs; each
//     recomputes the chunk's C x C scores;
//   * the chunk's prefix sum is one warp scan;
//   * x, B and C are read through strides (the last dimension contiguous):
//     the model passes B and C as one (b, S, N) tensor broadcast over heads
//     (head stride 0) and x as a view into the conv output, so nothing is
//     copied (a contiguous B and C would be H = 80 copies).
// Not done yet (later work): tensor-core products, staging the next chunk
// with cp.async/TMA, sharing one head's B/C tile across the heads of a block.
#include "chunk_scan.cuh"

namespace {

using namespace repro;
using namespace repro::chunk;

struct Strides {      // elements; the last dimension is contiguous
  long long b, s, h;
  __device__ __forceinline__ size_t at(int bb, int ss, int hh) const {
    return (size_t)(bb * b + ss * s + hh * h);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ Dv,
                 const float* __restrict__ h0, float* __restrict__ y,
                 float* __restrict__ h_out, int S, int H, int P, int N, int C,
                 Strides xs, Strides ds, Strides bs, Strides cs) {
  Smem& s = smem();
  const int b = blockIdx.z, h = blockIdx.y, p0 = blockIdx.x * VB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int np = min(VB, P - p0);
  const float a_h = A[h], d_h = Dv[h];
  const size_t state = (((size_t)b * H + h) * P + p0) * N;

  zero_smem(s);
  __syncthreads();
  for (int idx = tid; idx < np * N; idx += NT) {    // st[n][j] = h0[p0 + j][n]
    const int j = idx / N, n = idx % N;
    s.st[n * VB + j] = h0[state + idx];
  }

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();   // the previous chunk's carry is done with kr and vs
    for (int idx = tid; idx < C * N; idx += NT) {
      const int i = idx / N, n = idx % N;
      s.kd[i * KP + n] = to_f32<T>(Bm[bs.at(b, c0 + i, h) + n]);
      s.qd[i * KP + n] = to_f32<T>(Cm[cs.at(b, c0 + i, h) + n]);
    }
    for (int idx = tid; idx < C * VB; idx += NT) {
      const int i = idx / VB, j = idx % VB;
      if (j < np) s.xr[idx] = to_f32<T>(x[xs.at(b, c0 + i, h) + p0 + j]);
    }
    for (int i = tid; i < C; i += NT) s.row[i] = dt[ds.at(b, c0 + i, h)];
    __syncthreads();

    if (warp == 0) {   // cum_i = sum_{l<=i} dt_l A, padding positions 0
      const float la0 = lane < C ? s.row[lane] * a_h : 0.f;
      const float la1 = lane + 32 < C ? s.row[lane + 32] * a_h : 0.f;
      float cum0, cum1, last;
      scan64(la0, la1, cum0, cum1, last);
      s.cum[lane] = cum0;
      s.cum[lane + 32] = cum1;
      if (lane == 0) s.cum_last = last;
    }
    __syncthreads();

    const float last = s.cum_last;
    for (int idx = tid; idx < C * VB; idx += NT)          // dt_j x_j
      s.vs[idx] = s.xr[idx] * s.row[idx / VB];
    for (int idx = tid; idx < C * N; idx += NT) {         // B_j exp(cum_C - cum_j)
      const int i = idx / N, n = idx % N;
      s.kr[i * KP + n] = s.kd[i * KP + n] * expf(last - s.cum[i]);
    }
    for (int n = tid; n < N; n += NT) s.cl[n] = expf(last);
    {  // scores (C_i . B_j) exp(clip(cum_i - cum_j, -60, 0)) on j <= i
      float acc[4][4];
      score_tile(s.qd, s.kd, N, acc);
      const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = ty + 16 * a, j = tx + 16 * bb;
          const float decay =
              expf(fminf(fmaxf(s.cum[i] - s.cum[j], -60.f), 0.f));
          s.sc[i * CP + j] = j <= i ? acc[a][bb] * decay : 0.f;
        }
    }
    __syncthreads();   // every score tile has read the raw C
    for (int idx = tid; idx < C * N; idx += NT) {         // C_i exp(cum_i)
      const int i = idx / N, n = idx % N;
      s.qd[i * KP + n] *= expf(s.cum[i]);
    }
    __syncthreads();

    {
      float out[8];
      readout(s, C, N, out);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = warp + 8 * a;
        if (i < C && lane < np)
          y[(((size_t)b * S + c0 + i) * H + h) * P + p0 + lane] =
              out[a] + d_h * s.xr[i * VB + lane];
      }
    }
    __syncthreads();   // every readout has read the old state
    carry(s, C, N);
  }

  __syncthreads();
  for (int idx = tid; idx < np * N; idx += NT) {
    const int j = idx / N, n = idx % N;
    h_out[state + idx] = s.st[n * VB + j];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, const void* h0, void* y,
           void* h_out, int B, int S, int H, int P, int N, int C, Strides xs,
           Strides ds, Strides bs, Strides cs, cudaStream_t stream) {
  static bool configured[64] = {};
  auto kern = ssd_chunk_kernel<T>;
  const int e = allow_smem(kern, configured);
  if (e != 0) return e;
  dim3 grid((P + VB - 1) / VB, H, B), block(NT);
  kern<<<grid, block, sizeof(Smem), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, H, P, N, C, xs, ds, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,S,H,P), Bm and Cm (B,S,H,N) in T (bf16 or fp32), each read through
// (batch, position, head) strides in elements with the last dimension
// contiguous; dt (B,S,H) fp32 through its three strides; A, D (H,) and h0
// (B,H,P,N) fp32 contiguous; outputs y (B,S,H,P) and h_out (B,H,P,N) fp32
// contiguous. Returns cudaGetLastError() after the launch, or -1 for a shape
// the kernel does not take.
extern "C" int repro_ssd_chunk(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* Dv, const void* h0, void* y, void* h_out,
    int B, int S, int H, int P, int N, int C, long long xs_b, long long xs_s,
    long long xs_h, long long ds_b, long long ds_s, long long ds_h,
    long long bs_b, long long bs_s, long long bs_h, long long cs_b,
    long long cs_s, long long cs_h, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || C <= 0 ||
      N > KMAX || C > CMAX || S % C != 0 || B > 65535 || H > 65535)
    return -1;
  const Strides xs{xs_b, xs_s, xs_h}, ds{ds_b, ds_s, ds_h},
      bs{bs_b, bs_s, bs_h}, cs{cs_b, cs_s, cs_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, h0, y, h_out, B, S, H, P,
                              N, C, xs, ds, bs, cs, st)
      : launch<float>(x, dt, A, Bm, Cm, Dv, h0, y, h_out, B, S, H, P, N, C,
                      xs, ds, bs, cs, st);
}
