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
// What bounds it on this card. The function does 4*D operations per score
// and reads O(S*D) bytes for O(S^2*D) work, so at the model's shapes (a few
// hundred positions, <= 0.5 GFLOP a call) neither the tensor-core peak nor
// the memory rate is reached. What sets the time is the work each warp
// issues on its own scheduler for each 64-key tile (32 + 32 mma.sync, 64
// exponentials, the row reductions), times the tiles the longest block
// walks: at S = 512 causal and non-causal take the same time.
//
// bf16 inputs: a FlashAttention-2 design on the tensor cores.
//   * one block per (q tile of 64 rows, query head, batch row), 4 warps of
//     16 query rows each; causal tiles are scheduled heaviest first;
//   * both products are mma.sync.m16n8k16 (bf16 operands, fp32
//     accumulators). Q's fragments are loaded once with ldmatrix; K with
//     ldmatrix, V with ldmatrix.trans, so neither is transposed in memory;
//   * the score fragment is masked and exponentiated in registers (one FFMA
//     folds the 1/sqrt(D) * log2 e scale and the row maximum, one ex2 on
//     the SFU), then packed to bf16, where it is already laid out as the A
//     operand of P V: P never goes to shared memory. Row max and row sum
//     are reduced over the 4 lanes of a quad; (m, l, acc) stay fp32;
//   * K and V tiles of 64 rows are staged with cp.async into a two-stage
//     ring in shared memory, so tile j + 1 loads while tile j is computed,
//     with one barrier a tile. Rows are padded by 16 bytes, which puts the 8
//     rows an ldmatrix phase reads on 8 distinct bank groups;
//   * ragged tails are never padded in memory: rows past Sq or Skv are
//     filled with zeros by cp.async's source size 0 and masked; the causal
//     and tail masks are applied only on tiles that need them, and a warp
//     skips a KV tile wholly above its own 16 rows' diagonal.
// Numerics: rounding P to bf16 before P V is the one rounding the fp32
// reference does not make (relative 2^-9 per probability, averaged over
// the row); tests/test_torch_attention_designs.py holds a model of it
// within the bf16 tolerance of the reference. ex2.approx differs from exp
// by ~2^-22 relative, far below that.
// Measured and not kept (PERF.md): 128-row q tiles, two m-tiles a
// warp, 128-row KV tiles, 3- to 6-stage rings, and two or four warp groups
// splitting the KV tiles of a block; none was faster at the model's shapes.
// Left for later: a wgmma / TMA warp-specialised version (FlashAttention-3
// style: a producer warp, 64-row warpgroup products, softmax overlapped with
// the next tile's product), which moves work off each warp's scheduler.
//
// fp32 inputs: fp32 FMAs on the CUDA cores (a tensor-core product would
// round fp32 to TF32, outside the 2e-5 tolerance). A 16x16 thread grid holds
// a 4x4 register micro-tile of the scores; Q, K, V are kept in padded fp32
// shared-memory tiles; P goes through shared memory.
#include "common.cuh"

namespace {

using namespace repro;

// -- fp32: CUDA-core FMAs -----------------------------------------------------

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

// -- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (source size
// 0: nothing is read, the source address is only required to be valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// 2^x on the SFU (relative error ~2^-22; -inf and large negatives give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

constexpr int TC_WARPS = 4;               // warps a block, 16 rows each
constexpr int TC_BQ = 16 * TC_WARPS;      // query rows a block
constexpr int TC_BKV = 64;                // KV rows a stage

template <int D> constexpr size_t tc_smem_bytes() {
  return (size_t)(TC_BQ + 4 * TC_BKV) * (D + 8) * sizeof(bf16);
}

// Fragment layout of mma.m16n8k16 (lane = 4 * gr + tq): the accumulator
// holds rows gr and gr + 8, columns 2 tq and 2 tq + 1 of its 16x8 tile
// (c[0], c[1] and c[2], c[3]); the A operand the same rows, columns 2 tq,
// 2 tq + 1 (a[0] / a[1]) and 2 tq + 8, 2 tq + 9 (a[2] / a[3]).
template <int D>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            int Sq, int Skv, int Hq, int Hkv, int causal,
                            int q_offset, float scale_log2) {
  constexpr int NT_ = TC_WARPS * 32;
  constexpr int LD = D + 8;          // padded shared-memory row, in bf16
  constexpr int CH = D / 8;          // 16-byte chunks a row
  constexpr int KS = D / 16;         // k-steps of Q K^T
  constexpr int NS = TC_BKV / 8;     // 8-column tiles of S
  constexpr int NO = D / 8;          // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);   // [BQ][LD]
  bf16* Ks = Qs + TC_BQ * LD;                    // [2][BKV][LD]
  bf16* Vs = Ks + 2 * TC_BKV * LD;               // [2][BKV][LD]

  // causal tiles further down the diagonal do more work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const bf16* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const bf16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  int kv_end = Skv;
  if (causal) kv_end = max(0, min(Skv, min(q0 + TC_BQ, Sq) + q_offset));
  const int n_tiles = (kv_end + TC_BKV - 1) / TC_BKV;

  auto load_kv = [&](int tile) {
    bf16* kd = Ks + (tile & 1) * TC_BKV * LD;
    bf16* vd = Vs + (tile & 1) * TC_BKV * LD;
    for (int i = threadIdx.x; i < TC_BKV * CH; i += NT_) {
      const int r = i / CH, c = i % CH, row = tile * TC_BKV + r;
      const size_t off = (size_t)min(row, Skv - 1) * kstride + c * 8;
      cp_async16(kd + r * LD + c * 8, kb + off, row < Skv);
      cp_async16(vd + r * LD + c * 8, vb + off, row < Skv);
    }
  };
  for (int i = threadIdx.x; i < TC_BQ * CH; i += NT_) {
    const int r = i / CH, c = i % CH, row = q0 + r;
    cp_async16(Qs + r * LD + c * 8,
               qb + (size_t)min(row, Sq - 1) * qstride + c * 8, row < Sq);
  }
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int wrow = q0 + warp * 16;          // this warp's first query row
  const bool warp_live = wrow < Sq;
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  // m is the row maximum of the raw scores q.k; the probabilities are
  // exp2(s * scale_log2 - m * scale_log2), one FFMA and one ex2 a score
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    // the other stage was read by tile t - 1, which every warp has finished
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();

    const int k0 = t * TC_BKV;
    const bool above = causal && k0 > wrow + 15 + q_offset;
    if (warp_live && !above) {
      const bf16* Kt = Ks + (t & 1) * TC_BKV * LD;
      const bf16* Vt = Vs + (t & 1) * TC_BKV * LD;

      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      // S = Q K^T: registers 0/1 are the B operand of key tile 2 n2, 2/3 of
      // key tile 2 n2 + 1
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          unsigned kf[4];
          ldmatrix_x4(kf, Kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // mask only where the tile needs it
      if (k0 + TC_BKV > Skv ||
          (causal && k0 + TC_BKV - 1 > wrow + q_offset)) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + 2 * tq + (e & 1);
            const int qpos = wrow + gr + 8 * (e >> 1) + q_offset;
            if (kpos >= Skv || (causal && kpos > qpos)) s[n][e] = NEG_INF;
          }
      }

      // online softmax for this lane's two rows (gr and gr + 8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float corr = fast_exp2((m[r] - m_new) * scale_log2);
        const float off = -m_new * scale_log2;
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[n][2 * r] = fast_exp2(fmaf(s[n][2 * r], scale_log2, off));
          s[n][2 * r + 1] = fast_exp2(fmaf(s[n][2 * r + 1], scale_log2, off));
          rs += s[n][2 * r] + s[n][2 * r + 1];
        }
        l[r] = l[r] * corr + rs;       // this lane's share of the row sum
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }

      // O += P V: S tiles 2 kk and 2 kk + 1 are the A operand of k-step kk
#pragma unroll
      for (int kk = 0; kk < TC_BKV / 16; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          unsigned vf[4];
          ldmatrix_x4_trans(
              vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      n2 * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * n2], pa, vf[0], vf[1]);
          mma_bf16(o[2 * n2 + 1], pa, vf[2], vf[3]);
        }
      }
    }

    cp_async_wait_all();   // tile t + 1 has landed (this thread's copies)
    __syncthreads();       // ... everyone's; tile t is not read again
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = wrow + gr + 8 * r;
    if (row < Sq) {
      const float inv = 1.f / fmaxf(lr, 1e-20f);
      bf16* orow = out + (((size_t)b * Sq + row) * Hq + h) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<unsigned*>(orow + n * 8) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// Above 48 KB a block's shared memory is dynamic and must be asked for, once
// per device (and outside any stream capture, hence remembered).
template <typename K>
int allow_smem(K kern, size_t bytes, bool (&configured)[64]) {
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
  return 0;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
               float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  auto kern = flash_attention_kernel<float, D>;
  static bool configured[64] = {};
  const int err = allow_smem(kern, bytes, configured);
  if (err) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B), block(NT);
  kern<<<grid, block, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, Hq,
      Hkv, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                float scale, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<D>();
  auto kern = flash_attention_bf16_kernel<D>;
  static bool configured[64] = {};
  const int err = allow_smem(kern, bytes, configured);
  if (err) return err;
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, Hq, B), block(TC_WARPS * 32);
  kern<<<grid, block, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, Hq, Hkv,
      causal, q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
             int is_bf16, float scale, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                                  q_offset, scale, stream)
                 : launch_f32<D>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                                 q_offset, scale, stream);
}

}  // namespace

// q/out (B,Sq,Hq,D), k/v (B,Skv,Hkv,D); contiguous device pointers, 16-byte
// aligned for bf16. Returns cudaGetLastError() after the launch, or -1 for a
// shape the kernel does not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int Hq, int Hkv, int D,
                                     int causal, int q_offset, int is_bf16,
                                     float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq <= 0 ||
      Hq % Hkv != 0 || Hq > 65535 || B > 65535 || q_offset < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                          is_bf16, scale, s);
    case 64:
      return launch_d<64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                          is_bf16, scale, s);
    case 80:
      return launch_d<80>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                          is_bf16, scale, s);
    case 128:
      return launch_d<128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                           q_offset, is_bf16, scale, s);
    default:
      return -1;
  }
}
