// Shared helpers of the hand-written kernels: dtype conversion and small
// aligned vectors for 4/8/16-byte loads. Plain CUDA C++, no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

// Finite mask value, as in the reference: exp(NEG_INF - NEG_INF) is 1,
// where -inf would give NaN.
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

// N values of T moved by one load instruction (N * sizeof(T) in {2,4,8,16}).
template <typename T, int N> struct alignas(sizeof(T) * N) Vec { T v[N]; };

}  // namespace repro
