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
// What bounds it on this card: bytes by the work, latency in practice. Each
// step reads every live K and V row once and does about one multiply-add per
// byte read, far below the ~295 operations per byte at which an H100's
// tensor cores would be the limit, so the floor is (bytes of K and V up to
// cache_len) / HBM bandwidth: ~1.4 us for the batcher's step of
// smollm-360m. What sets the time instead is how long one block's chain of
// dependent loads, shuffles and exponentials takes, and how many blocks run
// side by side: one block per (row, KV head) is 40 blocks on 132 SMs at
// that step, and the longest row's block is the time.
//
// The design:
//   * split-KV. Each (batch row, KV head, head group) is split over nsplit
//     blocks, block s taking positions [s * chunk, (s + 1) * chunk) clipped
//     to the row's length. nsplit and chunk are chosen on the host from the
//     shapes alone (batch, heads, Smax, the SM count; never the lengths,
//     which stay on the device): about two blocks an SM, chunk a multiple of
//     256 so each of the 8 warps starts on a 32-position tile of its own.
//     (Blocks of 4 warps over 128-position splits measured slower at every
//     timed shape, PERF.md.) Each block reads its row's length on the
//     device and works out how many splits hold positions of it: the
//     splits past the row leave at once, and a row that fits the first
//     split is finished by that block alone, with no scratch or counter;
//   * the merge is in the same launch. Each block of a longer row writes
//     its partial (m, l, acc) to fp32 scratch, fences, and counts itself in
//     on a per-(row, head group) counter with atomicAdd; the last block to
//     arrive merges the row's partials (max / sum-exp, in split order, so
//     the result does not depend on which block came last), writes the
//     output and resets the counter to 0, which keeps the counters valid
//     across calls and CUDA-graph replays. Launches that share the counters
//     of a device must not overlap: the port issues them on one stream.
//     With nsplit = 1 no scratch or counter is touched (the single-pass
//     path);
//   * one block handles all g query heads of the group (G of them per
//     block, G a compile-time divisor of g up to 8), so each KV row is read
//     from memory once and reused g times;
//   * inside a block each of NW warps walks tiles of 32 positions with its
//     own (m, l, acc) in registers, and the NW partial states are merged
//     once through shared memory at the end;
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
//     they are used, to cover memory latency, the first VR together with
//     the tile's K rows (their addresses do not wait for the scores). Where 32 does not divide D
//     (D = 80, zamba2's shared attention) the row is padded to 96 and
//     masked: a lane holds columns lane, lane + 32 and lane + 64, loaded as
//     scalars (coalesced across the warp), the columns past D clamped to
//     D - 1 on load and dropped at the merge, so nothing branches there
//     either;
//   * no branch on data inside the tile loop: a position past the block's
//     range is clamped to its last live row and masked. (Per-row guards
//     make the compiler emit the loads one at a time, each waiting for the
//     last, and wrap every shuffle in a re-convergence sequence: measured
//     four times slower at the main path's shape.)
//   * the softmax denominator is kept per lane and summed across the warp
//     once, at the end;
//   * rows past cache_len[b] are never read.
// Left for later: cp.async/TMA staging of the K and V rows.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NW = 8;   // warps per block
constexpr int VR = 16;  // V rows a warp keeps in flight
constexpr int MAX_SPLIT = 64;   // splits of one row at most
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

// The largest divisor of n up to 8: how many of a K row's 16-byte loads are
// in flight at once (a divisor, so the unrolled loop covers the row).
__host__ __device__ constexpr int loads_in_flight(int n) {
  for (int c = 8; c > 1; --c)
    if (n % c == 0) return c;
  return 1;
}

// One V row as a lane holds it: E = ceil(D/32) elements, contiguous (one
// vector load) when 32 divides D, else columns lane + 32 e clamped to D - 1.
template <typename T, int D> struct VRow {
  static constexpr int E = (D + 31) / 32;
  static constexpr bool CONTIG = D % 32 == 0;
  T v[E];
  __device__ __forceinline__ void load(const T* row, int lane) {
    if constexpr (CONTIG) {
      const Vec<T, E> x = *reinterpret_cast<const Vec<T, E>*>(row + lane * E);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = x.v[e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = row[min(lane + 32 * e, D - 1)];
    }
  }
  // the output column of element e of this lane (>= D: padding)
  static __device__ __forceinline__ int col(int lane, int e) {
    return CONTIG ? lane * E + e : lane + 32 * e;
  }
};

// The row's log-sum-exp of the scaled scores from its final softmax state
// (maximum m, denominator l): -inf for a row with no position.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0xff800000u);
}

// Block (b * nsplit + s, hk, z) takes query heads h0 .. h0 + G - 1 of KV
// head hk over split s of row b. part holds, per (row, KV head, group,
// split), G * D accumulators, then G maxima, then G denominators.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ lens,
                        T* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part,
                        int* __restrict__ counters, int Smax, int Hq, int Hkv,
                        int nsplit, int chunk, float scale) {
  using V = VRow<T, D>;
  constexpr int E = V::E;                // output elements held by one lane
  constexpr int CN = Chunk<T>::N;        // elements per 16-byte load
  constexpr int NC = D / CN;             // 16-byte loads per K row
  constexpr int CB = loads_in_flight(NC);  // of which this many are in flight
  constexpr int PART = G * (D + 2);      // floats of one block's partial

  const int b = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int len = max(0, min(lens[b], Smax));
  // the splits that hold positions of this row (at least one, so a row of
  // length 0 still writes its zeros): the others leave at once, and a row
  // that fits the first split is finished by that block alone
  const int live = max(1, (len + chunk - 1) / chunk);
  if (split >= live) return;
  const int hk = blockIdx.y;
  const int h0 = hk * (Hq / Hkv) + blockIdx.z * G;
  const int unit = (b * Hkv + hk) * gridDim.z + blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int start = split * chunk;
  const int end = min(start + chunk, len);   // <= start: an empty range

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
  const T* vbase = vc + base;

  // Inside the loop nothing branches on data: a position past the range
  // reads the range's last row instead (a valid address) and is masked, so
  // the loads of a tile go out back to back and the shuffles need no
  // re-convergence.
  for (int j0 = start + warp * 32; j0 < end; j0 += NW * 32) {
    const int last = end - 1;
    const bool valid = j0 + lane < end;

    // the tile's first VR V rows go out with its K rows: their addresses
    // do not wait for the scores
    V vpre[VR];
#pragma unroll
    for (int r = 0; r < VR; ++r)
      vpre[r].load(vbase + (size_t)min(j0 + r, last) * row_stride, lane);

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

    // acc += P V, VR rows at a time; rows past the range carry p == 0
    auto accumulate = [&](const V (&vr)[VR], int r0) {
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
    };
    accumulate(vpre, 0);
#pragma unroll
    for (int r0 = VR; r0 < 32; r0 += VR) {
      if (j0 + r0 < end) {                  // uniform over the warp
        V vr[VR];
#pragma unroll
        for (int r = 0; r < VR; ++r)
          vr[r].load(vbase + (size_t)min(j0 + r0 + r, last) * row_stride,
                     lane);
        accumulate(vr, r0);
      }
    }
  }

  // merge the NW partial states of the block
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
    for (int e = 0; e < E; ++e) {
      const int c = V::col(lane, e);
      if (c < D) sm_acc[warp][gi][c] = acc[gi][e];
    }
  }
  __syncthreads();
  float* mine = live == 1 ? nullptr
                          : part + ((size_t)unit * nsplit + split) * PART;
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
    if (live == 1) {
      out[((size_t)b * Hq + h0 + gi) * D + d] =
          from_f32<T>(aa / fmaxf(ll, 1e-20f));
      if (lse != nullptr && d == 0)
        lse[(size_t)b * Hq + h0 + gi] = row_lse(mm, ll);
    } else {
      mine[idx] = aa;
      if (d == 0) {
        mine[G * D + gi] = mm;
        mine[G * D + G + gi] = ll;
      }
    }
  }
  if (live == 1) return;

  // count this block in; the last of the live blocks merges the partials
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(&counters[unit], 1) == live - 1;
    if (is_last) counters[unit] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // one warp a head: the weight exp(m_s - max m) of every split (lanes over
  // splits) and the merged denominator; then every thread merges its
  // columns, all the loads of a column in flight together
  const float* all = part + (size_t)unit * nsplit * PART;
  __shared__ float sm_f[G][MAX_SPLIT];
  __shared__ float sm_den[G];
  for (int gi = warp; gi < G; gi += NW) {
    float ms[MAX_SPLIT / 32], ls[MAX_SPLIT / 32], mm = NEG_INF;
#pragma unroll
    for (int i = 0; i < MAX_SPLIT / 32; ++i) {
      const int s = lane + 32 * i;
      ms[i] = s < live ? __ldcg(all + s * PART + G * D + gi) : NEG_INF;
      ls[i] = s < live ? __ldcg(all + s * PART + G * D + G + gi) : 0.f;
      mm = fmaxf(mm, ms[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, off));
    float ll = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SPLIT / 32; ++i) {
      const int s = lane + 32 * i;
      const float f = expf(ms[i] - mm);
      if (s < live) sm_f[gi][s] = f;
      ll += ls[i] * f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ll += __shfl_xor_sync(FULL, ll, off);
    if (lane == 0) {
      sm_den[gi] = fmaxf(ll, 1e-20f);
      if (lse != nullptr) lse[(size_t)b * Hq + h0 + gi] = row_lse(mm, ll);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int gi = idx / D;
    float aa = 0.f;
#pragma unroll 16
    for (int s = 0; s < live; ++s)
      aa += __ldcg(all + s * PART + idx) * sm_f[gi][s];
    out[((size_t)b * Hq + h0 + gi) * D + idx % D] =
        from_f32<T>(aa / sm_den[gi]);
  }
}

// Query heads per block: the largest of {8, 6, 4, 3, 2, 1} that divides the
// group size, so that every block handles exactly G heads and no loop in the
// kernel is guarded by a runtime head count. g = 3 (smollm-360m) takes one
// block per KV head; a group with no such divisor above 1 re-reads its KV
// rows once per query head (from L2 after the first). The split planner
// (kernels/decode_attention.py::split_plan) follows the same rule.
inline int heads_per_block(int g) {
  const int cands[] = {8, 6, 4, 3, 2};
  for (int cand : cands) {
    if (g % cand == 0) return cand;
  }
  return 1;
}

template <typename T, int D>
int launch_d(const void* q, const void* kc, const void* vc, const void* lens,
             void* out, void* lse, void* part, void* counters, int B,
             int Smax, int Hq, int Hkv, int nsplit, int chunk, float scale,
             cudaStream_t stream) {
  const int g = Hq / Hkv, G = heads_per_block(g);
  dim3 grid(B * nsplit, Hkv, g / G), block(NW * 32);
#define REPRO_DECODE_CASE(GG)                                                \
  case GG:                                                                   \
    decode_attention_kernel<T, D, GG><<<grid, block, 0, stream>>>(           \
        static_cast<const T*>(q), static_cast<const T*>(kc),                 \
        static_cast<const T*>(vc), static_cast<const int*>(lens),            \
        static_cast<T*>(out), static_cast<float*>(lse),                      \
        static_cast<float*>(part),                                           \
        static_cast<int*>(counters), Smax, Hq, Hkv, nsplit, chunk, scale);   \
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
           void* out, void* lse, void* part, void* counters, int B, int Smax,
           int Hq,
           int Hkv, int D, int nsplit, int chunk, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, kc, vc, lens, out, lse, part, counters, B,
                             Smax, Hq, Hkv, nsplit, chunk, scale, stream);
    case 64:
      return launch_d<T, 64>(q, kc, vc, lens, out, lse, part, counters, B,
                             Smax, Hq, Hkv, nsplit, chunk, scale, stream);
    case 80:
      return launch_d<T, 80>(q, kc, vc, lens, out, lse, part, counters, B,
                             Smax, Hq, Hkv, nsplit, chunk, scale, stream);
    case 128:
      return launch_d<T, 128>(q, kc, vc, lens, out, lse, part, counters, B,
                              Smax, Hq, Hkv, nsplit, chunk, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// q (B,1,Hq,D), caches (B,Smax,Hkv,D), lens (B,) int32, out (B,1,Hq,D); all
// contiguous device pointers. lse, when not null, is (B,Hq) fp32 and gets
// each row's log-sum-exp of the scaled scores (m + log l), -inf for a row of
// length 0: what a caller merging partial attentions over several caches
// needs beside out. Split s of a row covers positions
// [s * chunk, (s + 1) * chunk); the nsplit <= 64 splits must cover
// [0, Smax). With nsplit > 1, part is fp32 scratch of
// B * Hq * nsplit * (D + 2) floats and counters B * Hq int32 that are 0 on
// entry (and are 0 again on exit); with nsplit == 1 neither is touched.
// Returns cudaGetLastError() after the launch, or -1 for a shape the kernel
// does not take.
extern "C" int repro_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* lens,
                                      void* out, void* lse, void* part,
                                      void* counters, int B, int Smax, int Hq,
                                      int Hkv, int D, int nsplit, int chunk,
                                      int is_bf16, float scale, void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      Hkv > 65535 || nsplit <= 0 || nsplit > MAX_SPLIT || chunk <= 0 ||
      (long long)nsplit * chunk < Smax ||
      (long long)(nsplit - 1) * chunk >= Smax ||
      (long long)B * nsplit > 0x7fffffffLL ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(q, kc, vc, lens, out, lse, part, counters, B,
                              Smax, Hq, Hkv, D, nsplit, chunk, scale, s)
      : launch<float>(q, kc, vc, lens, out, lse, part, counters, B, Smax, Hq,
                      Hkv, D, nsplit, chunk, scale, s);
}
