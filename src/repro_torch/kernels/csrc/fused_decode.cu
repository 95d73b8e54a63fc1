// Three fused passes of DecoderLM's one-device decode step for Hopper
// (sm_90a): the residual add with the RMSNorm after it, the rotary
// embedding with the KV-cache write, and silu(g) * u.
//
// No TPU kernel to replace: the reference leaves these passes to XLA, which
// fuses them into its own loops (src/repro/models/layers.py :: rms_norm,
// rotate, swiglu; src/repro/models/transformer.py's decode step). In the
// port's captured decode step each was a chain of small PyTorch kernels:
// ~37 of a layer's ~49 graph nodes at smollm-360m's widths, each moving a
// few KB (a 64 x 960 bf16 activation is 123 KB, 37 ns at 3.35 TB/s).
//
// What bounds them: neither bytes nor operations but the launch and the
// gap between graph nodes (~1-2 us each). The design is one launch a pass,
// each input value read once and each output written once, intermediates
// in registers. Each pass rounds where the plain form (kernels/
// fused_decode.py) rounds: x + delta to the input dtype before the norm's
// fp32 statistics, the rotation's products and sums in fp32 with no fused
// multiply-add (__fmul_rn / __fadd_rn, as the plain form's separate
// kernels round), silu(g) to the input dtype before the product. Only the
// norm's sum of squares runs in another order than PyTorch's reduction.
#include "common.cuh"

namespace {

using namespace repro;

// -- residual add + RMSNorm ----------------------------------------------------
//
// One block a row, a thread owning VPT 16-byte vectors of it (8 bf16 or 4
// fp32 values), so the row stays in registers between the sum of squares
// and the scaling; the sum is a warp shuffle, then one more over the warps'
// partials in shared memory.

constexpr int NORM_THREADS = 512;   // most threads a row

template <typename T, int VPT>
__global__ void __launch_bounds__(NORM_THREADS) add_rms_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ delta,
    const float* __restrict__ weight, T* __restrict__ x_out,
    T* __restrict__ h_out, int d, float eps) {
  constexpr int N = 16 / sizeof(T);
  using V = Vec<T, N>;
  __shared__ float warp_sums[NORM_THREADS / 32];
  __shared__ float total;
  const int t = threadIdx.x, nvec = d / N;
  const size_t row = (size_t)blockIdx.x * d;

  float val[VPT][N];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = t + i * blockDim.x;
    if (j < nvec) {
      V a = reinterpret_cast<const V*>(x + row)[j];
      if (delta != nullptr) {
        // the residual, rounded to T as the plain form's add rounds it
        const V b = reinterpret_cast<const V*>(delta + row)[j];
#pragma unroll
        for (int e = 0; e < N; ++e)
          a.v[e] = from_f32<T>(to_f32(a.v[e]) + to_f32(b.v[e]));
        reinterpret_cast<V*>(x_out + row)[j] = a;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        val[i][e] = to_f32(a.v[e]);
        ss = fmaf(val[i][e], val[i][e], ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((t & 31) == 0) warp_sums[t >> 5] = ss;
  __syncthreads();
  if (t < 32) {
    float s = t < (int)(blockDim.x >> 5) ? warp_sums[t] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (t == 0) total = s;
  }
  __syncthreads();
  // the mean as PyTorch's reduction takes it (the sum times 1/d)
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, __frcp_rn((float)d)),
                                   eps));

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = t + i * blockDim.x;
    if (j < nvec) {
      const float4* w4 = reinterpret_cast<const float4*>(weight) + j * N / 4;
      float w[N];
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 f = w4[q];
        w[4 * q] = f.x;
        w[4 * q + 1] = f.y;
        w[4 * q + 2] = f.z;
        w[4 * q + 3] = f.w;
      }
      V out;
#pragma unroll
      for (int e = 0; e < N; ++e)
        out.v[e] = from_f32<T>(__fmul_rn(__fmul_rn(val[i][e], r), w[e]));
      reinterpret_cast<V*>(h_out + row)[j] = out;
    }
  }
}

template <typename T, int VPT>
int launch_norm(const void* x, const void* delta, const void* weight,
                void* x_out, void* h_out, int rows, int d, float eps,
                cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int per = (d / N + VPT - 1) / VPT;       // threads the row needs
  const int threads = (per + 31) / 32 * 32;
  add_rms_norm_kernel<T, VPT><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta),
      static_cast<const float*>(weight), static_cast<T*>(x_out),
      static_cast<T*>(h_out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_norm_vpt(const void* x, const void* delta, const void* weight,
                    void* x_out, void* h_out, int rows, int d, float eps,
                    cudaStream_t stream) {
  const int nvec = d / (16 / sizeof(T));
  if (nvec <= NORM_THREADS)
    return launch_norm<T, 1>(x, delta, weight, x_out, h_out, rows, d, eps,
                             stream);
  if (nvec <= 2 * NORM_THREADS)
    return launch_norm<T, 2>(x, delta, weight, x_out, h_out, rows, d, eps,
                             stream);
  if (nvec <= 4 * NORM_THREADS)
    return launch_norm<T, 4>(x, delta, weight, x_out, h_out, rows, d, eps,
                             stream);
  return launch_norm<T, 8>(x, delta, weight, x_out, h_out, rows, d, eps,
                           stream);
}

// -- rotary embedding + KV-cache write -----------------------------------------
//
// One block a batch row. A thread rotates (head, pair) elements of the
// row's Hq query heads and Hkv key heads: the query's into q_out, the
// key's straight into the cache at the row's position, then copies the
// row's v there. A position outside [0, Smax) writes nothing (the plain
// form's index_put_ would fault; the batcher never asks for one).

constexpr int ROPE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ROPE_THREADS) rope_kv_write_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ cosv,
    const float* __restrict__ sinv, T* __restrict__ k_cache,
    T* __restrict__ v_cache, const long long* __restrict__ lens,
    T* __restrict__ q_out, int Hq, int Hkv, int D, int Smax) {
  const int b = blockIdx.x, half = D >> 1;
  const long long pos = lens[b];
  const bool write = pos >= 0 && pos < Smax;
  const float* cb = cosv + (size_t)b * half;
  const float* sb = sinv + (size_t)b * half;
  const size_t slot = ((size_t)b * Smax + (write ? pos : 0)) * Hkv * D;
  const int pairs = (Hq + Hkv) * half;
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    const int h = i / half, j = i - h * half;
    const T* src;
    T* dst;
    if (h < Hq) {
      src = q + ((size_t)b * Hq + h) * D;
      dst = q_out + ((size_t)b * Hq + h) * D;
    } else if (write) {
      const int g = h - Hq;
      src = k + ((size_t)b * Hkv + g) * D;
      dst = k_cache + slot + (size_t)g * D;
    } else {
      continue;
    }
    const float x1 = to_f32(src[j]), x2 = to_f32(src[j + half]);
    const float c = cb[j], s = sb[j];
    dst[j] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    dst[j + half] = from_f32<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
  }
  if (write) {
    const T* vr = v + (size_t)b * Hkv * D;
    for (int i = threadIdx.x; i < Hkv * D; i += blockDim.x)
      v_cache[slot + i] = vr[i];
  }
}

// -- silu(g) * u ---------------------------------------------------------------
//
// A grid-stride pass over 16-byte vectors of g and u.

constexpr int SILU_THREADS = 256;
constexpr long long SILU_MAX_BLOCKS = 132 * 16;   // 16 blocks an SM at most

template <typename T>
__global__ void __launch_bounds__(SILU_THREADS) silu_mul_kernel(
    const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ out,
    long long nvec) {
  constexpr int N = 16 / sizeof(T);
  using V = Vec<T, N>;
  const V* gv = reinterpret_cast<const V*>(g);
  const V* uv = reinterpret_cast<const V*>(u);
  V* ov = reinterpret_cast<V*>(out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * blockDim.x) {
    const V a = gv[i], b = uv[i];
    V o;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float x = to_f32(a.v[e]);
      // silu rounded to T first, as F.silu(g) is, then the product
      const T s = from_f32<T>(__fdiv_rn(x, __fadd_rn(1.f, expf(-x))));
      o.v[e] = from_f32<T>(__fmul_rn(to_f32(s), to_f32(b.v[e])));
    }
    ov[i] = o;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

// x, delta (may be null), x_out (null when delta is), h_out: (rows, d) in T
// (bf16 or fp32); weight (d,) fp32; every pointer 16-byte aligned, d a
// multiple of 8 and at most 4,096 16-byte vectors (32,768 bf16, 16,384
// fp32).
// x_out = x + delta rounded to T; h_out = (x_out * rsqrt(mean(x_out^2) +
// eps) * weight) rounded to T. Returns cudaGetLastError() after the launch,
// or -1 for a shape the kernel does not take.
extern "C" int repro_add_rms_norm(const void* x, const void* delta,
                                  const void* weight, void* x_out,
                                  void* h_out, int rows, int d, float eps,
                                  int is_bf16, void* stream) {
  const int n = is_bf16 ? 8 : 4;
  if (rows <= 0 || d <= 0 || d % 8 != 0 || d / n > 8 * NORM_THREADS ||
      (delta == nullptr) != (x_out == nullptr) || !aligned16(x) ||
      !aligned16(weight) || !aligned16(h_out) ||
      (delta != nullptr && (!aligned16(delta) || !aligned16(x_out))))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_norm_vpt<__nv_bfloat16>(x, delta, weight, x_out, h_out,
                                          rows, d, eps, st);
  return launch_norm_vpt<float>(x, delta, weight, x_out, h_out, rows, d,
                                eps, st);
}

// q (B,1,Hq,D), k and v (B,1,Hkv,D), q_out (B,1,Hq,D) and the layer's
// caches (B,Smax,Hkv,D), all in T (bf16 or fp32); cos and sin (B,1,1,D/2)
// fp32; lens (B,) int64, each row's write position. D even, at most 128.
// Writes the rotated q into q_out and the rotated k and v into the caches
// at [b, lens[b]]. Returns cudaGetLastError() after the launch, or -1 for a
// shape the kernel does not take.
extern "C" int repro_rope_kv_write(const void* q, const void* k,
                                   const void* v, const void* cosv,
                                   const void* sinv, void* k_cache,
                                   void* v_cache, const void* lens,
                                   void* q_out, int B, int Hq, int Hkv, int D,
                                   int Smax, int is_bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || D < 2 || D > 128 || D % 2 != 0 ||
      Smax <= 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    rope_kv_write_kernel<__nv_bfloat16><<<B, ROPE_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const float*>(cosv), static_cast<const float*>(sinv),
        static_cast<__nv_bfloat16*>(k_cache),
        static_cast<__nv_bfloat16*>(v_cache),
        static_cast<const long long*>(lens),
        static_cast<__nv_bfloat16*>(q_out), Hq, Hkv, D, Smax);
  else
    rope_kv_write_kernel<float><<<B, ROPE_THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(cosv),
        static_cast<const float*>(sinv), static_cast<float*>(k_cache),
        static_cast<float*>(v_cache), static_cast<const long long*>(lens),
        static_cast<float*>(q_out), Hq, Hkv, D, Smax);
  return static_cast<int>(cudaGetLastError());
}

// g, u, out: n values of T (bf16 or fp32), 16-byte aligned, n a multiple of
// 8. out = silu(g) rounded to T, times u, rounded to T. Returns
// cudaGetLastError() after the launch, or -1 for a shape the kernel does
// not take.
extern "C" int repro_silu_mul(const void* g, const void* u, void* out,
                              long long n, int is_bf16, void* stream) {
  if (n <= 0 || n % 8 != 0 || !aligned16(g) || !aligned16(u) ||
      !aligned16(out))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nvec = n / (is_bf16 ? 8 : 4);
  long long blocks = (nvec + SILU_THREADS - 1) / SILU_THREADS;
  if (blocks > SILU_MAX_BLOCKS) blocks = SILU_MAX_BLOCKS;
  if (is_bf16)
    silu_mul_kernel<__nv_bfloat16><<<(int)blocks, SILU_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(u),
        static_cast<__nv_bfloat16*>(out), nvec);
  else
    silu_mul_kernel<float><<<(int)blocks, SILU_THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(u),
        static_cast<float*>(out), nvec);
  return static_cast<int>(cudaGetLastError());
}
