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
// What bounds it on this card. Per chunk and head four products of at most
// 64 x 64 x 64 on O(C (P + 2N)) input bytes. Run as fp32 FMAs (the first
// version) they made it bound by operations and by shared-memory
// wavefronts, 19x above the bound; as 3xTF32 tensor-core products (three
// TF32 products at 495 TFLOP/s) the function is bound by its bytes. What
// sets the time now is the work each warp issues per chunk (fragment loads,
// the split, the mma, the mask's exps), chained over the chunks.
//
// The design (chunk_scan.cuh has the parts shared with rwkv6_chunk.cu):
//   * a block owns one batch row, HPB heads and PB of the P columns, eight
//     warps a head (by default two heads and 32 columns where B and C are
//     shared over the heads: 80 blocks at zamba2-2.7b's 80 heads; one head
//     and 64 columns otherwise). The sequential chunk axis is a loop inside
//     the block;
//   * per chunk: C, B, x and dt of chunk c + 1 are copied by cp.async into
//     the other stage of a two-stage ring while chunk c computes, through
//     the strides the wrapper passes (B and C broadcast over the heads,
//     head stride 0, are copied once, never per head); three barriers;
//   * the Gram tile G = C B^T (the lower triangle's tiles) is computed once
//     per chunk for the block's heads when they share B and C, and each
//     head applies its own decay mask exp(clip(cum_i - cum_j, -60, 0)) dt_j
//     on j <= i while it loads G as the A operand of the readout;
//   * four reader warps a head compute the readout Y = exp(cum_i) (C h^T) +
//     S' x + D x for 16 rows each; four carrier warps hold the head's state
//     in their accumulator registers across chunks and compute the carry
//     h = exp(cum_C) h + (x w)^T B, w_j = dt_j exp(cum_C - cum_j), then copy
//     it, split into hi and lo parts, into shared memory for the next
//     chunk's readers. The decays are folded into scalar row and column
//     factors, so no decayed copy of C, B or x is made; every product is
//     3xTF32 mma.sync m16n8k8 (2 products where a bf16 input is exact);
//   * x, B and C are read through strides with the last dimension
//     contiguous (the model's x is a view into the conv output); rows past
//     the chunk and columns past N or P are zero-filled by the copies, never
//     padded in memory.
// ``design`` (csrc entry point below) forces another block shape or turns
// the prefetch off; chip_smoke.py times them (PERF.md). Left for
// later: wgmma, and the chunk-parallel (state-passing) form.
#include "chunk_scan.cuh"

namespace {

using namespace repro;
using namespace repro::chunk;

struct Strides {      // elements; the last dimension is contiguous
  long long b, s, h;
  __device__ __forceinline__ long long at(int bb, int ss, int hh) const {
    return bb * b + ss * s + hh * h;
  }
};

// Shared memory of one block. Pitches (in elements) keep the fragment loads
// free of bank conflicts: C is read with its k (= n) contiguous, 8 bytes a
// lane (pitch = 8 words mod 32); x is read k-major (4 words mod 32); B both
// ways (k-major, as the carry reads it more).
template <typename T, int HPB, int PB>
struct SsdSmem {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int CP = KMAX + 8, BP = KMAX + PAD, XP = PB + PAD;
  static constexpr int GP = CMAX + 8, HP = KMAX + 8;
  struct Stage {
    alignas(16) T c[CMAX * CP];
    alignas(16) T b[CMAX * BP];
    alignas(16) T x[HPB][CMAX * XP];
    alignas(16) float dt[HPB][CMAX];
  };
  Stage stage[2];
  alignas(16) float g[CMAX * GP];       // raw C B^T, lower triangle
  alignas(16) float h[HPB][2][PB * HP];  // each head's state [p][n]: hi, lo
  float cum[HPB][CMAX];                 // in-chunk prefix sums of dt A
  float rs[HPB][CMAX];                  // exp(cum_i)
  float wj[HPB][CMAX];                  // dt_j exp(cum_C - cum_j)
  float el[HPB];                        // exp(cum_C)
};

template <typename T, int HPB, int PB>
__global__ void __launch_bounds__(256 * HPB, 1)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ Dv,
                 const float* __restrict__ h0, float* __restrict__ y,
                 float* __restrict__ h_out, int S, int H, int P, int N, int C,
                 Strides xs, Strides ds, Strides bs, Strides cs, bool vec,
                 bool prefetch) {
  using Sm = SsdSmem<T, HPB, PB>;
  constexpr int NT = 256 * HPB, NWARP = NT / 32;
  constexpr int KS = KMAX / 8;          // k-steps of a full 64-wide product
  constexpr int GQ = (20 + NWARP - 1) / NWARP;   // Gram tiles a warp
  constexpr int YN = PB / 8;            // readout: 8-column tiles of a warp
  constexpr int CM = PB / 16;           // carry: 16-row tiles of the state
  constexpr int CN = 8 / (4 / CM);      // carry: 8-column tiles of a warp
  extern __shared__ float4 smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);

  const int b = blockIdx.z, p0 = blockIdx.x * PB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  // eight warps a head: four read out 16 rows each, four carry the state
  const int hh = warp >> 3, wi = warp & 7;
  const bool reader = wi < 4;
  const int h = blockIdx.y * HPB + hh;
  const bool live = h < H;
  const int np = min(PB, P - p0);
  const int nm = (C + 15) / 16, nk = (C + 7) / 8, nkn = (N + 7) / 8;
  const float a_h = live ? A[h] : 0.f, d_h = live ? Dv[h] : 0.f;
  const int h_first = blockIdx.y * HPB;         // B and C rows of the block

  auto issue = [&](int c) {
    typename Sm::Stage& st = s.stage[c & 1];
    const int c0 = c * C;
    copy_tile<NT, KMAX>(st.c, Sm::CP, Cm + cs.at(b, c0, h_first), cs.s, C, N,
                        vec);
    copy_tile<NT, KMAX>(st.b, Sm::BP, Bm + bs.at(b, c0, h_first), bs.s, C, N,
                        vec);
    for (int j = 0; j < HPB; ++j) {
      const int hj = min(blockIdx.y * HPB + j, H - 1);
      copy_tile<NT, PB>(st.x[j], Sm::XP, x + xs.at(b, c0, hj) + p0, xs.s, C,
                        np, vec);
    }
    for (int idx = threadIdx.x; idx < HPB * CMAX; idx += NT) {
      const int j = idx / CMAX, i = idx % CMAX;
      const int hj = min(blockIdx.y * HPB + j, H - 1);
      cp_async4(&st.dt[j][i], dt + ds.at(b, c0 + min(i, C - 1), hj), i < C);
    }
  };

  // a carry warp's state: the accumulators of rows p = 16 pm + gr (+ 8),
  // columns n = 8 (cn0 + t) + 2 tq (+ 1), with a copy in shared memory
  const int ci = wi - 4, pm = ci % CM, cn0 = (ci / CM) * CN;
  const size_t state = (((size_t)b * H + (live ? h : 0)) * P + p0) * N;
  float st[CN][4];
  if (!reader) {
#pragma unroll
    for (int t = 0; t < CN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * pm + gr + 8 * (e >> 1);
        const int n = 8 * (cn0 + t) + 2 * tq + (e & 1);
        st[t][e] =
            live && p < np && n < N ? h0[state + (size_t)p * N + n] : 0.f;
        store_split(s.h[hh][0], s.h[hh][1], p * Sm::HP + n, st[t][e]);
      }
  }

  const int nchunks = S / C;
  issue(0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (prefetch) {
      if (c + 1 < nchunks) issue(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (c > 0) issue(c);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk c has landed; chunk c - 1 is done with smem
    const typename Sm::Stage& sg = s.stage[c & 1];

    if (wi == 0) {     // the head's prefix sums, padding positions 0
      const float la0 = lane < C ? sg.dt[hh][lane] * a_h : 0.f;
      const float la1 = lane + 32 < C ? sg.dt[hh][lane + 32] * a_h : 0.f;
      float cum0, cum1, last;
      scan64(la0, la1, cum0, cum1, last);
      s.cum[hh][lane] = cum0;
      s.cum[hh][lane + 32] = cum1;
      s.rs[hh][lane] = expf(cum0);
      s.rs[hh][lane + 32] = expf(cum1);
      s.wj[hh][lane] = sg.dt[hh][lane] * expf(last - cum0);
      s.wj[hh][lane + 32] = sg.dt[hh][lane + 32] * expf(last - cum1);
      if (lane == 0) s.el[hh] = expf(last);
    }
    {  // G = C B^T on the tiles (i tile mt, j tile jt <= 2 mt + 1) that the
       // readout reads, 20 at C = 64; a warp takes up to GQ of them at once
      const int ntile = nm * (nm + 1);
      int mt[GQ], jt[GQ];
      float acc[GQ][4];
#pragma unroll
      for (int q = 0; q < GQ; ++q) {
        const int t = min(warp + q * NWARP, 19);
        mt[q] = t < 2 ? 0 : t < 6 ? 1 : t < 12 ? 2 : 3;
        jt[q] = t - mt[q] * (mt[q] + 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nkn) break;
#pragma unroll
        for (int q = 0; q < GQ; ++q) {
          if (warp + q * NWARP >= ntile) break;
          float a[4];
          ld_a_rows(sg.c, Sm::CP, 16 * mt[q], 8 * ks, a);
          mma_in<T>(acc[q], frag_a(a),
                    ld_b_rows(sg.b, Sm::BP, 8 * jt[q], 8 * ks));
        }
      }
#pragma unroll
      for (int q = 0; q < GQ; ++q) {
        if (warp + q * NWARP >= ntile) break;
        float* g = s.g + (16 * mt[q] + gr) * Sm::GP + 8 * jt[q] + 2 * tq;
        *reinterpret_cast<float2*>(g) = make_float2(acc[q][0], acc[q][1]);
        *reinterpret_cast<float2*>(g + 8 * Sm::GP) =
            make_float2(acc[q][2], acc[q][3]);
      }
    }
    __syncthreads();   // G, the prefix sums and the factors are in place

    const int i0 = 16 * wi;
    if (live && reader && i0 < C) {
      // readout of rows i0 .. i0 + 15: exp(cum_i) (C h^T) + S' x + D x
      float acc[YN][4];
#pragma unroll
      for (int t = 0; t < YN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nkn) break;
        float a[4];
        ld_a_rows(sg.c, Sm::CP, i0, 8 * ks, a);
        const FragA fa = frag_a(a);
#pragma unroll
        for (int t = 0; t < YN; ++t)
          mma3(acc[t], fa, ld_b_rows_split(s.h[hh][0], s.h[hh][1], Sm::HP,
                                           8 * t, 8 * ks));
      }
      const float r0 = s.rs[hh][i0 + gr], r1 = s.rs[hh][i0 + gr + 8];
      const float ci0 = s.cum[hh][i0 + gr], ci1 = s.cum[hh][i0 + gr + 8];
#pragma unroll
      for (int t = 0; t < YN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] *= e < 2 ? r0 : r1;
      // S'_ij = G_ij exp(clip(cum_i - cum_j, -60, 0)) dt_j on j <= i
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= min(2 * wi + 2, nk)) break;
        const int j = 8 * ks + 2 * tq;
        float a[4];
        ld_a_rows(s.g, Sm::GP, i0, 8 * ks, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gr + 8 * (e & 1), jj = j + (e >> 1);
          const float cii = (e & 1) ? ci1 : ci0;
          // the SFU's exp: its argument lies in [-60, 0], its relative
          // error stays below 4e-6
          const float decay =
              __expf(fminf(fmaxf(cii - s.cum[hh][jj], -60.f), 0.f));
          a[e] = jj <= i ? a[e] * decay * sg.dt[hh][jj] : 0.f;
        }
        const FragA fa = frag_a(a);
#pragma unroll
        for (int t = 0; t < YN; ++t)
          mma_in<T>(acc[t], fa, ld_b_cols(sg.x[hh], Sm::XP, 8 * t, 8 * ks));
      }
#pragma unroll
      for (int t = 0; t < YN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gr + 8 * (e >> 1), p = 8 * t + 2 * tq + (e & 1);
          if (i < C && p < np)
            y[(((size_t)b * S + c * C + i) * H + h) * P + p0 + p] =
                acc[t][e] + d_h * to_f32<T>(sg.x[hh][i * Sm::XP + p]);
        }
    }
    if (live && !reader) {
      // carry: h = exp(cum_C) h + sum_j (x_j w_j)^T B_j
      const float el = s.el[hh];
#pragma unroll
      for (int t = 0; t < CN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] *= el;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nk) break;
        float a[4];
        ld_a_cols(sg.x[hh], Sm::XP, 16 * pm, 8 * ks, a);
        const float w0 = s.wj[hh][8 * ks + 2 * tq];
        const float w1 = s.wj[hh][8 * ks + 2 * tq + 1];
        a[0] *= w0;
        a[1] *= w0;
        a[2] *= w1;
        a[3] *= w1;
        const FragA fa = frag_a(a);
#pragma unroll
        for (int t = 0; t < CN; ++t)
          mma_in<T>(st[t], fa,
                    ld_b_cols(sg.b, Sm::BP, 8 * (cn0 + t), 8 * ks));
      }
    }
    __syncthreads();   // every readout has read the old state
    if (!reader) {
#pragma unroll
      for (int t = 0; t < CN; ++t) {
        const int at = (16 * pm + gr) * Sm::HP + 8 * (cn0 + t) + 2 * tq;
        store_split2(s.h[hh][0], s.h[hh][1], at, st[t][0], st[t][1]);
        store_split2(s.h[hh][0], s.h[hh][1], at + 8 * Sm::HP, st[t][2],
                     st[t][3]);
      }
    }
  }

  if (!live || reader) return;
#pragma unroll
  for (int t = 0; t < CN; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * pm + gr + 8 * (e >> 1);
      const int n = 8 * (cn0 + t) + 2 * tq + (e & 1);
      if (p < np && n < N) h_out[state + (size_t)p * N + n] = st[t][e];
    }
}

template <typename T, int HPB, int PB>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, const void* h0, void* y,
           void* h_out, int B, int S, int H, int P, int N, int C, Strides xs,
           Strides ds, Strides bs, Strides cs, bool prefetch,
           cudaStream_t stream) {
  static bool configured[64] = {};
  auto kern = ssd_chunk_kernel<T, HPB, PB>;
  const int bytes = (int)sizeof(SsdSmem<T, HPB, PB>);
  const int e = allow_smem(kern, bytes, configured);
  if (e != 0) return e;
  // 16-byte copies need 16-byte aligned rows
  const long long el = sizeof(T);
  const bool vec = aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   (xs.b * el) % 16 == 0 && (xs.s * el) % 16 == 0 &&
                   (xs.h * el) % 16 == 0 && (bs.b * el) % 16 == 0 &&
                   (bs.s * el) % 16 == 0 && (bs.h * el) % 16 == 0 &&
                   (cs.b * el) % 16 == 0 && (cs.s * el) % 16 == 0 &&
                   (cs.h * el) % 16 == 0 && (PB * el) % 16 == 0;
  dim3 grid((P + PB - 1) / PB, (H + HPB - 1) / HPB, B), block(256 * HPB);
  kern<<<grid, block, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, H, P, N, C, xs, ds, bs, cs, vec,
      prefetch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,S,H,P), Bm and Cm (B,S,H,N) in T (bf16 or fp32), each read through
// (batch, position, head) strides in elements with the last dimension
// contiguous; dt (B,S,H) fp32 through its three strides; A, D (H,) and h0
// (B,H,P,N) fp32 contiguous; outputs y (B,S,H,P) and h_out (B,H,P,N) fp32
// contiguous. ``design`` 0 lets the launcher choose the block shape: two
// heads and 32 columns a block where B and C are shared over the heads, one
// head and 64 columns otherwise. 1..4 force one (fp32 only, for timing):
// 1 = one head and 64 columns without prefetch, 2 = the same with it, 3 =
// one head and 32 columns, 4 = two heads and 32 columns without prefetch
// (shared B and C only). Returns cudaGetLastError() after the launch, or -1
// for a shape or design the kernel does not take.
extern "C" int repro_ssd_chunk(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* Dv, const void* h0, void* y, void* h_out,
    int B, int S, int H, int P, int N, int C, long long xs_b, long long xs_s,
    long long xs_h, long long ds_b, long long ds_s, long long ds_h,
    long long bs_b, long long bs_s, long long bs_h, long long cs_b,
    long long cs_s, long long cs_h, int is_bf16, int design, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || C <= 0 ||
      N > KMAX || C > CMAX || S % C != 0 || B > 65535 || H > 65535 ||
      design < 0 || design > 4 || (is_bf16 && design != 0))
    return -1;
  const Strides xs{xs_b, xs_s, xs_h}, ds{ds_b, ds_s, ds_h},
      bs{bs_b, bs_s, bs_h}, cs{cs_b, cs_s, cs_h};
  const bool shared_bc = bs_h == 0 && cs_h == 0;
  if (design == 4 && !shared_bc) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_LAUNCH(T, HPB, PB, PRE)                                    \
  launch<T, HPB, PB>(x, dt, A, Bm, Cm, Dv, h0, y, h_out, B, S, H, P, N, C,   \
                     xs, ds, bs, cs, PRE, st)
  if (is_bf16) return REPRO_SSD_LAUNCH(__nv_bfloat16, 1, 64, true);
  switch (design) {
    case 1: return REPRO_SSD_LAUNCH(float, 1, 64, false);
    case 2: return REPRO_SSD_LAUNCH(float, 1, 64, true);
    case 3: return REPRO_SSD_LAUNCH(float, 1, 32, true);
    case 4: return REPRO_SSD_LAUNCH(float, 2, 32, false);
    default:   // two heads of 32 columns measured fastest at zamba2's shape
      return shared_bc ? REPRO_SSD_LAUNCH(float, 2, 32, true)
                       : REPRO_SSD_LAUNCH(float, 1, 64, true);
  }
#undef REPRO_SSD_LAUNCH
}
