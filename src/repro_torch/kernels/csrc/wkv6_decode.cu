// One decode step of the RWKV6 (WKV) recurrence for Hopper (sm_90a), in
// place in the layer's slice of the cache.
//
// No TPU kernel to replace: the reference decodes in jnp
// (src/repro/kernels/chunked.py :: wkv6_decode, with the port's rule that a
// row at length 0 starts from zero state). Per (batch row b, head h), with
// the fp32 state S (dk x dv) of the cache:
//     y[v]     = sum_k r[k] S[k][v] + v[v] * sum_k r[k] u[k] k[k]
//     S'[k][v] = w[k] S[k][v] + k[k] v[v]
// the first being r^T (S + diag(u) k v^T) of the chunked form. A row whose
// cache_len is 0 takes S = 0 and does not read it. Arithmetic is fp32 FMA.
//
// What bounds it. One token's work is 4 FMAs per state element, against 8
// bytes of state read and written: far below the ridge, so the time is the
// state's bytes, and the design is about moving each of them once. The
// plain form (chunked.wkv6_decode, the state multiplied by the rows' keep
// and copied back) passes over the state about nine times.
//
// The design: one block of 256 threads per (b, h), 4,096 blocks at
// rwkv6-7b's batch of 64. A thread owns a float4 of the dv columns over
// the rows g, g + G, g + 2G, ... (G = 256 / (dv / 4) row groups: at dv = 64
// 16 groups of 4 rows), so a warp reads and writes whole 256-byte rows in
// 128-bit accesses. Each thread issues all its row loads before anything
// else, then stages r, k, w, v in shared memory while they are in flight;
// its y partial needs no shuffle, and only the row groups' partials are
// combined, through shared memory. Each state element is read once and
// written once, by the thread that owns it.
#include <limits.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int DMAX = 128;   // the largest dk and dv taken

template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS) wkv6_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ state,
    const int* __restrict__ lens, float* __restrict__ y, int H, int dk,
    int dv) {
  __shared__ float sr[DMAX], sk[DMAX], sw[DMAX], sv[DMAX];
  __shared__ __align__(16) float part[THREADS * 4];
  __shared__ float bonus;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int t = threadIdx.x;
  const int Q = dv >> 2, G = THREADS / Q;   // float4 columns, row groups
  const int q = t % Q, g = t / Q;
  const bool owner = g < G;
  const bool live = lens[b] > 0;
  float4* S = reinterpret_cast<float4*>(state + (size_t)bh * dk * dv);

  // every row load of this thread in flight before any is used
  float4 s[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = g + i * G;
    s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && owner && row < dk) s[i] = S[row * Q + q];
  }

  // this (b, h)'s token: r, k, w, v, and the bonus sum_k r u k
  const size_t in = (size_t)bh * dk;
  if (t < dk) {
    sr[t] = to_f32(r[in + t]);
    sk[t] = to_f32(k[in + t]);
    sw[t] = w[in + t];
  }
  if (t < dv) sv[t] = to_f32(v[(size_t)bh * dv + t]);
  if (t < 32) {
    float a = 0.f;
    for (int j = t; j < dk; j += 32)
      a = fmaf(to_f32(r[in + j]) * u[(size_t)h * dk + j], to_f32(k[in + j]),
               a);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (t == 0) bonus = a;
  }
  __syncthreads();

  // the readout's partial over this thread's rows, and the new state
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (owner) {
    const float4 vq = make_float4(sv[4 * q], sv[4 * q + 1], sv[4 * q + 2],
                                  sv[4 * q + 3]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = g + i * G;
      if (row < dk) {
        const float rr = sr[row], ww = sw[row], kk = sk[row];
        acc.x = fmaf(rr, s[i].x, acc.x);
        acc.y = fmaf(rr, s[i].y, acc.y);
        acc.z = fmaf(rr, s[i].z, acc.z);
        acc.w = fmaf(rr, s[i].w, acc.w);
        float4 n;
        n.x = fmaf(ww, s[i].x, kk * vq.x);
        n.y = fmaf(ww, s[i].y, kk * vq.y);
        n.z = fmaf(ww, s[i].z, kk * vq.z);
        n.w = fmaf(ww, s[i].w, kk * vq.w);
        S[row * Q + q] = n;
      }
    }
  }

  // the row groups' partials summed per column, plus the bonus
  reinterpret_cast<float4*>(part)[t] = acc;
  __syncthreads();
  if (t < dv) {
    float sum = 0.f;
    for (int gg = 0; gg < G; ++gg) sum += part[gg * Q * 4 + t];
    y[(size_t)bh * dv + t] = fmaf(sv[t], bonus, sum);
  }
}

template <typename T, int RPT>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* state, const void* lens, void* y, int B,
           int H, int dk, int dv, cudaStream_t stream) {
  wkv6_decode_kernel<T, RPT><<<B * H, THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(state),
      static_cast<const int*>(lens), static_cast<float*>(y), H, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* state, const void* lens, void* y, int B,
                int H, int dk, int dv, cudaStream_t stream) {
  const int G = THREADS / (dv / 4);
  const int rows = (dk + G - 1) / G;   // at most 16: dk <= 128, G >= 8
  if (rows <= 4)
    return launch<T, 4>(r, k, v, w, u, state, lens, y, B, H, dk, dv, stream);
  if (rows <= 8)
    return launch<T, 8>(r, k, v, w, u, state, lens, y, B, H, dk, dv, stream);
  return launch<T, 16>(r, k, v, w, u, state, lens, y, B, H, dk, dv, stream);
}

}  // namespace

// r, k (B,H,dk) and v (B,H,dv) in T (bf16 or fp32), one token each; w
// (B,H,dk) and u (H,dk) in fp32; state (B,H,dk,dv) fp32, read and written
// in place (16-byte aligned); lens (B,) int32; y (B,H,dv) fp32 out. All
// contiguous device pointers. dk in [1, 128], dv a multiple of 4 in
// [4, 128]. Returns cudaGetLastError() after the launch, or -1 for a shape
// the kernel does not take.
extern "C" int repro_wkv6_decode(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* state,
                                 const void* lens, void* y, int B, int H,
                                 int dk, int dv, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || dk <= 0 || dk > DMAX || dv < 4 || dv > DMAX ||
      dv % 4 != 0 || (long long)B * H > INT_MAX ||
      reinterpret_cast<size_t>(state) % 16 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_rows<__nv_bfloat16>(r, k, v, w, u, state, lens, y, B, H,
                                      dk, dv, st);
  return launch_rows<float>(r, k, v, w, u, state, lens, y, B, H, dk, dv, st);
}
