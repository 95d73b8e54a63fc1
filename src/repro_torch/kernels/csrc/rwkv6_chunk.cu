// Chunk-parallel RWKV6 (WKV) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_chunk.py :: wkv6_pallas
// (body _wkv_kernel). Same function: per head, with a (dk x dv) state S,
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// evaluated chunk by chunk in the matmul form of kernels/chunked.py (cum =
// in-chunk prefix sums of log w; q_dec = r exp(cum_i), k_dec = k exp(-cum_{j+1}),
// strictly-lower scores plus the u bonus on the diagonal, y = scores v +
// q_dec S, S <- exp(cum_C) S + k_rem^T v). Returns y and the final state in
// fp32; every exp and prefix sum is fp32 whatever the input dtype. Same
// stability contract as the reference: |log w| * chunk < ~80.
//
// What bounds it on this card: operations. Per chunk of C positions and per
// head it does four C x 64 x 64-sized products (~2 MFLOP at C = 64) on
// O(C * 64) input bytes, about 60 FLOP per byte read in bf16 — above the
// fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), since this
// first version runs its products as fp32 FMAs on the CUDA cores.
//
// What the design does about that (shared with ssd_chunk.cu, chunk_scan.cuh):
//   * the TPU grid's sequential chunk axis is a loop inside the block, the
//     state slice in shared memory in fp32 across it;
//   * a block owns one (batch row, head) and VB = 32 of the dv columns, so
//     rwkv6-7b's 64 heads at batch 1 give 128 blocks for 132 SMs instead of
//     64; each block recomputes the chunk's C x C scores, which do not
//     depend on the columns (the price: scores cost 2x at dv = 64);
//   * in-chunk prefix sums of log w are warp scans, one warp per dk column,
//     over a transposed copy of log w (conflict-free column walks);
//   * the products are register-tiled from shared memory (4 x 4 micro-tiles
//     for the scores, 8 rows a thread for readout and carry), reading
//     16-byte rows as float4: the first version read one float per
//     shared-memory wavefront and was bound by those wavefronts.
// Not done yet (later work): tensor-core products on bf16 tiles (the fp32
// tolerance of 1e-4 rules out TF32), cp.async/TMA staging of the next chunk.
#include "chunk_scan.cuh"

namespace {

using namespace repro;
using namespace repro::chunk;

template <typename T>
__global__ void __launch_bounds__(NT, 1)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int S,
                  int H, int dk, int dv, int C) {
  Smem& s = smem();
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * VB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nv = min(VB, dv - j0);
  const size_t kstride = (size_t)H * dk;    // one position of r, k, w
  const size_t vstride = (size_t)H * dv;    // one position of v, y
  const size_t state = ((size_t)b * H + h) * dk * dv + j0;

  zero_smem(s);
  __syncthreads();
  for (int idx = tid; idx < dk * VB; idx += NT) {
    const int kk = idx / VB, j = idx % VB;
    if (j < nv) s.st[idx] = s0[state + (size_t)kk * dv + j];
  }

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();   // the previous chunk's carry is done with kr and vs
    for (int idx = tid; idx < C * dk; idx += NT) {
      const int i = idx / dk, kk = idx % dk;
      const size_t off = ((size_t)b * S + c0 + i) * kstride + (size_t)h * dk + kk;
      s.qd[i * KP + kk] = to_f32<T>(r[off]);
      s.kd[i * KP + kk] = to_f32<T>(k[off]);
      s.lw[kk * TP + i] = logf(w[off]);
    }
    for (int idx = tid; idx < C * VB; idx += NT) {
      const int i = idx / VB, j = idx % VB;
      if (j < nv)
        s.vs[idx] = to_f32<T>(
            v[((size_t)b * S + c0 + i) * vstride + (size_t)h * dv + j0 + j]);
    }
    __syncthreads();

    // bonus_i = r_i . (u * k_i), one warp per position; and one warp per dk
    // column: the prefix sums of log w over the chunk (positions lane and
    // lane + 32, padding positions 0)
    for (int i = warp; i < C; i += NWARP) {
      float acc = 0.f;
      for (int kk = lane; kk < dk; kk += 32)
        acc += s.qd[i * KP + kk] * (u[h * dk + kk] * s.kd[i * KP + kk]);
      acc = warp_sum(acc);
      if (lane == 0) s.row[i] = acc;
    }
    for (int kk = warp; kk < dk; kk += NWARP) {
      float cum0, cum1, last;
      scan64(s.lw[kk * TP + lane], s.lw[kk * TP + lane + 32], cum0, cum1, last);
      s.cumT[kk * TP + lane] = cum0;
      s.cumT[kk * TP + lane + 32] = cum1;
      if (lane == 0) {
        s.last[kk] = last;
        s.cl[kk] = expf(last);
      }
    }
    __syncthreads();

    // q_dec, k_dec and k_rem in place of r and k, row by row
    for (int idx = tid; idx < C * dk; idx += NT) {
      const int i = idx / dk, kk = idx % dk;
      const float cum = s.cumT[kk * TP + i], lw = s.lw[kk * TP + i];
      const float rr = s.qd[i * KP + kk], kv = s.kd[i * KP + kk];
      s.qd[i * KP + kk] = rr * expf(cum - lw);          // r_i exp(cum_i)
      s.kd[i * KP + kk] = kv * expf(-cum);              // k_j exp(-cum_{j+1})
      s.kr[i * KP + kk] = kv * expf(s.last[kk] - cum);  // k_j exp(cum_C - cum_{j+1})
    }
    __syncthreads();

    // scores: strictly lower triangle, the bonus on the diagonal
    {
      float acc[4][4];
      score_tile(s.qd, s.kd, dk, acc);
      const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = ty + 16 * a, j = tx + 16 * bb;
          s.sc[i * CP + j] = j < i ? acc[a][bb] : (j == i ? s.row[i] : 0.f);
        }
    }
    __syncthreads();

    {
      float out[8];
      readout(s, C, dk, out);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = warp + 8 * a;
        if (i < C && lane < nv)
          y[((size_t)b * S + c0 + i) * vstride + (size_t)h * dv + j0 + lane] =
              out[a];
      }
    }
    __syncthreads();   // every readout has read the old state
    carry(s, C, dk);
  }

  __syncthreads();
  for (int idx = tid; idx < dk * VB; idx += NT) {
    const int kk = idx / VB, j = idx % VB;
    if (j < nv) s_out[state + (size_t)kk * dv + j] = s.st[idx];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B, int S,
           int H, int dk, int dv, int C, cudaStream_t stream) {
  static bool configured[64] = {};
  auto kern = wkv6_chunk_kernel<T>;
  const int e = allow_smem(kern, configured);
  if (e != 0) return e;
  dim3 grid((dv + VB - 1) / VB, H, B), block(NT);
  kern<<<grid, block, sizeof(Smem), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H, dk, dv, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k (B,S,H,dk) and v (B,S,H,dv) in T (bf16 or fp32); w (B,S,H,dk), u (H,dk),
// s0 (B,H,dk,dv) in fp32; outputs y (B,S,H,dv) and s_out (B,H,dk,dv) in fp32.
// All contiguous device pointers. Returns cudaGetLastError() after the
// launch, or -1 for a shape the kernel does not take.
extern "C" int repro_wkv6_chunk(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* y, void* s_out, int B, int S, int H,
                                int dk, int dv, int C, int is_bf16,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || C <= 0 ||
      dk > KMAX || C > CMAX || S % C != 0 || B > 65535 || H > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, S, H, dk, dv, C, st)
      : launch<float>(r, k, v, w, u, s0, y, s_out, B, S, H, dk, dv, C, st);
}
