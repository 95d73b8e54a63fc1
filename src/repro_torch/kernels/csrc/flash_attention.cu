// Blocked causal / non-causal GQA attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention_pallas (body _attn_kernel). Same function: scores
// q.k^T/sqrt(D), causal mask kpos <= qpos + q_offset, online softmax over KV
// tiles with fp32 (m, l, acc), out = acc / max(l, 1e-20), query head h
// reading KV head h / g. Where the Pallas wrapper asserts that both sequence
// lengths are multiples of the block, this kernel masks the ragged tails
// (as the blocked jnp form does by padding).
//
// What bounds it on this card: operations. At D = 64 the function does
// 4*D = 256 floating-point operations per score and reads O(S*D) bytes for
// O(S^2*D) work, so past a few hundred positions it sits above the memory
// roofline. This first version does its two products (Q K^T and P V) with
// fp32 FMAs on the CUDA cores for both I/O dtypes: that keeps fp32 inputs
// exact to fp32 (a tensor-core path would round them to TF32) and keeps one
// code path, at the price of the bf16 tensor-core rate. Its floor in PERF.md
// is therefore stated against the tensor-core peak for bf16 and the fp32
// CUDA-core peak for fp32, and the gap is this kernel's to close later
// (wgmma on bf16 tiles, TMA loads, a deeper pipeline).
//
// What the design does within that:
//   * one block per (q tile of BQ rows, query head, batch row); the TPU
//     form's sequential KV grid axis becomes a loop inside the block, bounded
//     by the causal diagonal, so tiles above it are never loaded;
//   * Q, K, V tiles are converted to fp32 once into shared memory and every
//     loaded K/V element is reused by all BQ query rows of the tile;
//   * a 16x16 thread grid holds a 4x4 register micro-tile of the scores, so
//     each shared-memory read feeds four FMAs; row-wise max and sum stay in
//     a half-warp and are reduced with shuffles;
//   * padded shared-memory rows keep the strided accesses free of bank
//     conflicts.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int BQ = 64;     // query rows per block
constexpr int BKV = 64;    // KV rows per loop step
constexpr int NT = 256;    // threads per block, a 16 x 16 grid
constexpr int PP = BKV + 16;   // padded row of the probability tile

template <int D> constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
         (size_t)BQ * PP;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int Hq, int Hkv, int causal, int q_offset,
                       float scale) {
  constexpr int DP = D + 1;    // padded row of the Q and K tiles
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][DP], pre-scaled
  float* Ks = Qs + BQ * DP;       // [BKV][DP]
  float* Vs = Ks + BKV * DP;      // [BKV][D]
  float* Ps = Vs + BKV * D;       // [BQ][PP]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, row = q0 + r;
    Qs[r * DP + d] = row < Sq
        ? to_f32<T>(q[(((size_t)b * Sq + row) * Hq + h) * D + d]) * scale
        : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: the last query row of this tile sees keys up to its own position
  int kv_end = Skv;
  if (causal) kv_end = max(0, min(Skv, min(q0 + BQ, Sq) + q_offset));

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();   // the previous step's reads of Ks / Vs / Ps are done
    for (int idx = threadIdx.x; idx < BKV * D; idx += NT) {
      const int r = idx / D, d = idx % D, row = k0 + r;
      float kf = 0.f, vf = 0.f;
      if (row < Skv) {
        const size_t off = (((size_t)b * Skv + row) * Hkv + hk) * D + d;
        kf = to_f32<T>(k[off]);
        vf = to_f32<T>(v[off]);
      }
      Ks[r * DP + d] = kf;
      Vs[r * D + d] = vf;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= Skv || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a score row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty + 16 i, output columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        out[(((size_t)b * Sq + row) * Hq + h) * D + tx + 16 * c] =
            from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
             float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  // above 48 KB shared memory is dynamic and must be asked for, once per
  // device (and outside any stream capture, hence remembered)
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return -1;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B), block(NT);
  kern<<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, Hq, Hkv, causal,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                             q_offset, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                             q_offset, scale, stream);
    case 80:   // zamba2's shared attention: five output columns a thread
      return launch_d<T, 80>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                             q_offset, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                              q_offset, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// q/out (B,Sq,Hq,D), k/v (B,Skv,Hkv,D); contiguous device pointers. Returns
// cudaGetLastError() after the launch, or -1 for a shape the kernel does not
// take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int Hq, int Hkv, int D,
                                     int causal, int q_offset, int is_bf16,
                                     float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq <= 0 ||
      Hq % Hkv != 0 || Hq > 65535 || B > 65535 || q_offset < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal,
                              q_offset, scale, s)
      : launch<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, q_offset,
                      scale, s);
}
