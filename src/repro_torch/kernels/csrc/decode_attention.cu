// Flash-decode attention for Hopper (sm_90a): one query token per batch row
// against a GQA KV cache with a per-row length.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention_pallas (body _decode_kernel). It computes the same
// function: scores q.k^T/sqrt(D), positions >= cache_len masked, online
// softmax state (m, l, acc) in fp32, out = acc / max(l, 1e-20), query head h
// reading KV head h / g so the cache is never widened. Like the Pallas body
// it returns 0 for a row whose length is 0 (every position skipped). Unlike
// the Pallas wrapper it takes one length per batch row.
//
// What bounds it on this card: bytes. Each step reads every live K and V row
// once and does about one multiply-add per byte read, far below the ~295
// operations per byte at which an H100's tensor cores would be the limit, so
// the floor is (bytes of K and V up to cache_len) / HBM bandwidth.
//
// What the design does about that:
//   * one block per (batch row, KV head) handles all g query heads of the
//     group (G of them per block, G a compile-time divisor of g up to 8), so
//     each KV row is read from memory once and reused g times;
//   * the TPU form walks the KV axis as a sequential grid dimension with the
//     state in VMEM scratch; blocks on a GPU run in no order, so the KV loop
//     is inside the block: each of NW warps walks tiles of 32 positions with
//     its own (m, l, acc) in registers, and the NW partial states are merged
//     once through shared memory at the end (the same max / sum-exp merge a
//     split-KV kernel does across blocks);
//   * scores: one lane per position. A lane reads its whole K row with
//     16-byte loads and takes the g dot products against the query (kept in
//     shared memory, read as broadcasts), so a score needs no cross-lane
//     reduction; only the tile's maximum is reduced across the warp, once
//     per tile and head. (Splitting every row over the 32 lanes instead
//     costs five dependent shuffles per score, and with two warps per
//     scheduler that chain of latencies, not memory, sets the time.)
//   * values: one row per load instruction, each lane holding D/32
//     contiguous elements of the output; the lane that owns a position's
//     probability broadcasts it with one shuffle. VR rows are loaded before
//     they are used, to cover memory latency;
//   * no branch on data inside the tile loop: a position past the length is
//     clamped to the last live row and masked. (Per-row guards make the
//     compiler emit the loads one at a time, each waiting for the last,
//     and wrap every shuffle in a re-convergence sequence: measured four
//     times slower at the main path's shape.)
//   * the softmax denominator is kept per lane and summed across the warp
//     once, at the end;
//   * the loop stops at cache_len[b]: rows past the length are never read.
// Not done yet (later work): splitting one row's KV range across blocks so
// that small B*Hkv still fills 132 SMs, cp.async/TMA staging.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NW = 8;   // warps per block
constexpr int VR = 16;  // V rows a warp keeps in flight
constexpr unsigned FULL = 0xffffffffu;

// One 16-byte load widened to fp32: 4 floats, or 8 bf16 (a bf16 is the upper
// half of the fp32 with the same value).
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ lens,
                        T* __restrict__ out, int Smax, int Hq, int Hkv,
                        float scale) {
  constexpr int E = D / 32;              // output elements held by one lane
  constexpr int CN = Chunk<T>::N;        // elements per 16-byte load
  constexpr int NC = D / CN;             // 16-byte loads per K row
  constexpr int CB = NC < 8 ? NC : 8;    // of which this many are in flight
  using V = Vec<T, E>;

  // block (b, hk, z) takes query heads h0 .. h0 + G - 1 of KV head hk
  const int b = blockIdx.x, hk = blockIdx.y;
  const int h0 = hk * (Hq / Hkv) + blockIdx.z * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = max(0, min(lens[b], Smax));

  // the group's queries, pre-scaled, in shared memory
  __shared__ __align__(16) float qs[G][D];
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int gi = idx / D, d = idx % D;
    qs[gi][d] = to_f32<T>(q[((size_t)b * Hq + h0 + gi) * D + d]) * scale;
  }
  __syncthreads();

  float acc[G][E], m[G], l[G];   // l: this lane's share of the denominator
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  const size_t base = ((size_t)b * Smax * Hkv + hk) * D;
  const T* kbase = kc + base;
  const T* vbase = vc + base + lane * E;

  // Inside the loop nothing branches on data: a position past the length
  // reads the last live row instead (a valid address) and is masked, so the
  // loads of a tile go out back to back and the shuffles need no
  // re-convergence.
  for (int j0 = warp * 32; j0 < len; j0 += NW * 32) {
    const int last = len - 1;
    const bool valid = j0 + lane < len;

    // scores of position j0 + lane for every head of the group
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
    const uint4* kp = reinterpret_cast<const uint4*>(
        kbase + (size_t)min(j0 + lane, last) * row_stride);
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += CB) {
      uint4 raw[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) raw[c] = kp[c0 + c];
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        float kf[CN];
        Chunk<T>::unpack(raw[c], kf);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float4* q4 =
              reinterpret_cast<const float4*>(&qs[gi][(c0 + c) * CN]);
#pragma unroll
          for (int i = 0; i < CN / 4; ++i) {
            const float4 qq = q4[i];
            s[gi] += qq.x * kf[4 * i] + qq.y * kf[4 * i + 1] +
                     qq.z * kf[4 * i + 2] + qq.w * kf[4 * i + 3];
          }
        }
      }
    }

    // online softmax: the tile's maximum is the only warp-wide reduction
    float p[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = valid ? s[gi] : NEG_INF;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[gi], mx);
      const float corr = expf(m[gi] - m_new);
      p[gi] = valid ? expf(s[gi] - m_new) : 0.f;
      l[gi] = l[gi] * corr + p[gi];
      m[gi] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= corr;
    }

    // acc += P V, VR rows at a time; rows past the length carry p == 0
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += VR) {
      if (j0 + r0 < len) {                  // uniform over the warp
        V vr[VR];
#pragma unroll
        for (int r = 0; r < VR; ++r)
          vr[r] = *reinterpret_cast<const V*>(
              vbase + (size_t)min(j0 + r0 + r, last) * row_stride);
#pragma unroll
        for (int r = 0; r < VR; ++r) {
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const float pj = __shfl_sync(FULL, p[gi], r0 + r);
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[gi][e] += pj * to_f32<T>(vr[r].v[e]);
          }
        }
      }
    }
  }

  // merge the NW partial states
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float lsum = l[gi];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(FULL, lsum, off);
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = lsum;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][gi][lane * E + e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int gi = idx / D, d = idx % D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][gi]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][gi] - mm);
      ll += sm_l[w][gi] * f;
      aa += sm_acc[w][gi][d] * f;
    }
    out[((size_t)b * Hq + h0 + gi) * D + d] =
        from_f32<T>(aa / fmaxf(ll, 1e-20f));
  }
}

// Query heads per block: the largest of {8, 6, 4, 3, 2, 1} that divides the
// group size, so that every block handles exactly G heads and no loop in the
// kernel is guarded by a runtime head count. g = 3 (smollm-360m) takes one
// block per KV head; a group with no such divisor above 1 re-reads its KV
// rows once per query head (from L2 after the first).
inline int heads_per_block(int g) {
  const int cands[] = {8, 6, 4, 3, 2};
  for (int cand : cands) {
    if (g % cand == 0) return cand;
  }
  return 1;
}

template <typename T, int D>
int launch_d(const void* q, const void* kc, const void* vc, const void* lens,
             void* out, int B, int Smax, int Hq, int Hkv, float scale,
             cudaStream_t stream) {
  const int g = Hq / Hkv, G = heads_per_block(g);
  dim3 grid(B, Hkv, g / G), block(NW * 32);
#define REPRO_DECODE_CASE(GG)                                                \
  case GG:                                                                   \
    decode_attention_kernel<T, D, GG><<<grid, block, 0, stream>>>(           \
        static_cast<const T*>(q), static_cast<const T*>(kc),                 \
        static_cast<const T*>(vc), static_cast<const int*>(lens),            \
        static_cast<T*>(out), Smax, Hq, Hkv, scale);                         \
    break;
  switch (G) {
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(3)
    REPRO_DECODE_CASE(4)
    REPRO_DECODE_CASE(6)
    REPRO_DECODE_CASE(8)
    default:
      return -1;
  }
#undef REPRO_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* lens,
           void* out, int B, int Smax, int Hq, int Hkv, int D, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, kc, vc, lens, out, B, Smax, Hq, Hkv, scale,
                             stream);
    case 64:
      return launch_d<T, 64>(q, kc, vc, lens, out, B, Smax, Hq, Hkv, scale,
                             stream);
    case 128:
      return launch_d<T, 128>(q, kc, vc, lens, out, B, Smax, Hq, Hkv, scale,
                              stream);
    default:
      return -1;
  }
}

}  // namespace

// q (B,1,Hq,D), caches (B,Smax,Hkv,D), lens (B,) int32, out (B,1,Hq,D); all
// contiguous device pointers. Returns cudaGetLastError() after the launch,
// or -1 for a shape the kernel does not take.
extern "C" int repro_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* lens,
                                      void* out, int B, int Smax, int Hq,
                                      int Hkv, int D, int is_bf16, float scale,
                                      void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      Hkv > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(q, kc, vc, lens, out, B, Smax, Hq, Hkv, D, scale, s)
      : launch<float>(q, kc, vc, lens, out, B, Smax, Hq, Hkv, D, scale, s);
}
