// Chunk-parallel RWKV6 (WKV) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_chunk.py :: wkv6_pallas
// (body _wkv_kernel). Same function: per head, with a (dk x dv) state S,
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// evaluated chunk by chunk in the matmul form of kernels/chunked.py (cum =
// in-chunk prefix sums of log w; q_dec = r exp(cum_i), k_dec = k exp(-cum_{j+1}),
// strictly-lower scores plus the u bonus on the diagonal, y = scores v +
// q_dec S, S <- exp(cum_C) S + k_rem^T v). Returns y and the final state in
// fp32; every exp, log and prefix sum is fp32 whatever the input dtype. Same
// stability contract as the reference: |log w| * chunk < ~80.
//
// What bounds it on this card. Per chunk of C positions and per head four
// C x 64 x 64-sized products on O(C * 64) input bytes. As fp32 FMAs (the
// first version) they made it bound by operations and by shared-memory
// wavefronts, 14x above its bound; as 3xTF32 tensor-core products the
// function is bound by its bytes. What sets the time now is the work each
// warp issues per chunk (fragment loads, the split, the mma) and the
// per-element decays, chained over the chunks inside each block.
//
// The design (chunk_scan.cuh has the parts shared with ssd_chunk.cu):
//   * a block owns one (batch row, head) and VB of the dv columns (32 by
//     default: 128 blocks at rwkv6-7b's 64 heads, one an SM); the chunk
//     loop runs inside the block;
//   * r, k, v and w of chunk c + 1 are copied by cp.async into the other
//     stage of a two-stage ring while chunk c computes;
//   * the decay factors q_dec, k_dec and k_rem are computed once per chunk
//     for the block's columns by all its threads: one log per (position,
//     key channel), a two-pass prefix sum (a thread walks a segment of one
//     channel's positions, then adds the segments before it), three exps;
//   * the four products are 3xTF32 mma.sync m16n8k8 (two products where v
//     is bf16, exact in TF32), in two roles of four warps for every 32
//     columns. A reader warp owns 16 rows of the chunk: its score tile
//     (strictly lower, the u bonus (r u) k^T on the diagonal) stays in
//     registers, where it is already the A operand of scores v. A carrier
//     warp owns 16 state rows, held in its accumulator registers across
//     chunks: it computes q_dec S for its reader's rows from the old state
//     and hands it over in shared memory, then exp(cum_C) S + k_rem^T v,
//     and writes the new state, split into hi and lo parts, for the next
//     chunk's q_dec S. The decayed factors are split once, as written.
//     Four barriers a chunk.
// ``design`` (csrc entry point below) forces another block shape or turns
// the prefetch off; chip_smoke.py times them (PERF.md). Left for
// later: wgmma; computing the next chunk's decay factors while this one's
// products run; the chunk-parallel (state-passing) form.
#include "chunk_scan.cuh"

namespace {

using namespace repro;
using namespace repro::chunk;

// Shared memory of one block. r, k, w are read a row at a time, r and k
// also as operands of the bonus; v k-major as a B operand (pitch 4 words
// mod 32). The decayed factors and the state are split once into hi and lo
// tiles by the threads that write them; q_dec and k_dec are read with
// their k contiguous (8 words mod 32), k_rem and the state k-major (4 words
// mod 32). Two stages of inputs in bf16; one in fp32, where two do not fit
// beside the split tiles.
template <typename T, int VB, int NSEG>
struct WkvSmem {
  static constexpr int NSTAGE = sizeof(T) == 2 ? 2 : 1;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int RP = KMAX + PAD, VP = VB + PAD, WP = KMAX + 4;
  static constexpr int QP = KMAX + 8, KRP = KMAX + 4, SP = VB + 4;
  struct Stage {
    alignas(16) T r[CMAX * RP];
    alignas(16) T k[CMAX * RP];
    alignas(16) T v[CMAX * VP];
    alignas(16) float w[CMAX * WP];
  };
  Stage stage[NSTAGE];
  alignas(16) float qd[2][CMAX * QP];   // r_i exp(cum_i): hi, lo
  alignas(16) float kd[2][CMAX * QP];   // k_j exp(-cum_{j+1}); first the sums
  alignas(16) float kr[2][CMAX * KRP];  // k_j exp(cum_C - cum_{j+1})
  alignas(16) float st[2][KMAX * SP];   // the state slice [dk][VB]
  alignas(16) float yq[CMAX * SP];      // q_dec S, from the carriers
  float tot[NSEG][KMAX];                // per segment: its sum of log w
  float cl[KMAX];                       // exp(cum_C) per state row
  float u[KMAX];                        // the head's bonus weights
};

template <typename T, int VB, int WC>
__global__ void __launch_bounds__(256 * WC, 1)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int S,
                  int H, int dk, int dv, int C, bool vec, bool prefetch) {
  constexpr int NT = 256 * WC, NSEG = NT / KMAX, SEGL = CMAX / NSEG;
  constexpr int KS = KMAX / 8;               // k-steps of a 64-wide product
  constexpr int CW = VB / WC, CT = CW / 8;   // a warp's columns, 8-col tiles
  using Sm = WkvSmem<T, VB, NSEG>;
  extern __shared__ float4 smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * VB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  // the first 4 WC warps read out, the others carry the state: each owns
  // 16 rows (16 mt) and CW columns (from c0)
  const bool reader = warp < 4 * WC;
  const int rw = reader ? warp : warp - 4 * WC;
  const int mt = rw & 3, c0 = (rw >> 2) * CW;
  const int nv = min(VB, dv - j0);
  const int nk = (C + 7) / 8, nkd = (dk + 7) / 8;
  const long long kstride = (long long)H * dk;   // one position of r, k, w
  const long long vstride = (long long)H * dv;   // one position of v, y
  const size_t state = ((size_t)b * H + h) * dk * dv + j0;
  prefetch = prefetch && Sm::NSTAGE == 2;

  auto issue = [&](int c) {
    typename Sm::Stage& sg = s.stage[c % Sm::NSTAGE];
    const long long pos = (long long)b * S + c * C;
    const long long off = pos * kstride + (long long)h * dk;
    copy_tile<NT, KMAX>(sg.r, Sm::RP, r + off, kstride, C, dk, vec);
    copy_tile<NT, KMAX>(sg.k, Sm::RP, k + off, kstride, C, dk, vec);
    copy_tile<NT, KMAX>(sg.w, Sm::WP, w + off, kstride, C, dk, vec);
    copy_tile<NT, VB>(sg.v, Sm::VP, v + pos * vstride + (long long)h * dv + j0,
                      vstride, C, nv, vec);
  };

  for (int kk = tid; kk < KMAX; kk += NT)
    s.u[kk] = kk < dk ? u[h * dk + kk] : 0.f;
  // the carry's accumulators: state rows 16 mt + gr (+ 8), columns
  // c0 + 8 t + 2 tq (+ 1)
  float st[CT][4];
  if (!reader) {
#pragma unroll
    for (int t = 0; t < CT; ++t)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int kk = 16 * mt + gr + 4 * e;
        const int j = c0 + 8 * t + 2 * tq;
        const size_t at = state + (size_t)kk * dv + j;
        st[t][e] = kk < dk && j < nv ? s0[at] : 0.f;
        st[t][e + 1] = kk < dk && j + 1 < nv ? s0[at + 1] : 0.f;
        store_split2(s.st[0], s.st[1], kk * Sm::SP + j, st[t][e],
                     st[t][e + 1]);
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
      if (c > 0) issue(c);   // chunk c - 1 read its stage before X
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk c has landed; chunk c - 1 is done with smem
    const typename Sm::Stage& sg = s.stage[c % Sm::NSTAGE];

    // prefix sums of log w, first pass: thread (channel kk, segment seg)
    // sums its segment's positions, padding positions 0
    const int kk = tid % KMAX, seg = tid / KMAX;
    {
      float acc = 0.f;
      for (int i = seg * SEGL; i < (seg + 1) * SEGL; ++i) {
        acc += i < C && kk < dk ? logf(sg.w[i * Sm::WP + kk]) : 0.f;
        s.kd[0][i * Sm::QP + kk] = acc;
      }
      s.tot[seg][kk] = acc;
    }
    __syncthreads();

    // second pass: the decayed factors, one log and three exps per
    // (position, channel) for the whole block, split as they are written
    {
      float off = 0.f, last = 0.f;
#pragma unroll
      for (int q = 0; q < NSEG; ++q) {
        off += q < seg ? s.tot[q][kk] : 0.f;
        last += s.tot[q][kk];
      }
      float prev = off;                                     // cum_i
      for (int i = seg * SEGL; i < (seg + 1) * SEGL; ++i) {
        const int at = i * Sm::QP + kk;
        const float incl = s.kd[0][at] + off;               // cum_{i+1}
        const float rv = to_f32<T>(sg.r[i * Sm::RP + kk]);
        const float kv = to_f32<T>(sg.k[i * Sm::RP + kk]);
        store_split(s.qd[0], s.qd[1], at, rv * expf(prev));
        store_split(s.kd[0], s.kd[1], at, kv * expf(-incl));
        store_split(s.kr[0], s.kr[1], i * Sm::KRP + kk,
                    kv * expf(last - incl));
        prev = incl;
      }
      if (seg == 0) s.cl[kk] = expf(last);
    }
    __syncthreads();

    const int i0 = 16 * mt;
    float acc[CT][4];
    if (reader && i0 < C) {
      // scores of rows i0 .. i0 + 15 against key tiles jt <= 2 mt + 1, and
      // the bonus tile (r u) k^T on the diagonal tiles 2 mt, 2 mt + 1
      float sc[8][4], bt[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) sc[jt][e] = 0.f;
        bt[0][e] = bt[1][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nkd) break;
        const FragA fa = ld_a_rows_split(s.qd[0], s.qd[1], Sm::QP, i0, 8 * ks);
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
          if (jt <= 2 * mt + 1)
            mma3(sc[jt], fa,
                 ld_b_rows_split(s.kd[0], s.kd[1], Sm::QP, 8 * jt, 8 * ks));
        float a[4];
        ld_a_rows(sg.r, Sm::RP, i0, 8 * ks, a);
        const float u0 = s.u[8 * ks + 2 * tq], u1 = s.u[8 * ks + 2 * tq + 1];
        a[0] *= u0;
        a[1] *= u0;
        a[2] *= u1;
        a[3] *= u1;
        const FragA fb = frag_a(a);
        mma_in<T>(bt[0], fb, ld_b_rows(sg.k, Sm::RP, i0, 8 * ks));
        mma_in<T>(bt[1], fb, ld_b_rows(sg.k, Sm::RP, i0 + 8, 8 * ks));
      }
#pragma unroll
      for (int t = 0; t < CT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        if (jt > 2 * mt + 1 || 8 * jt >= C) continue;
        // strictly lower, the bonus on the diagonal; the accumulator tile
        // is the A operand of k-step jt as it stands
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gr + 8 * (e >> 1), j = 8 * jt + 2 * tq + (e & 1);
          const float bo = jt == 2 * mt ? bt[0][e] : bt[1][e];
          a[(e & 1) * 2 + (e >> 1)] =
              j < i ? sc[jt][e] : (j == i ? bo : 0.f);
        }
        const FragA fa = frag_a(a);
#pragma unroll
        for (int t = 0; t < CT; ++t)
          mma_in<T>(acc[t], fa, ld_b_cols(sg.v, Sm::VP, c0 + 8 * t, 8 * jt));
      }
    }
    if (!reader) {
      // q_dec S for the readers' rows 16 mt .. (the old state), then the
      // carry of state rows 16 mt ..: exp(cum_C) S + k_rem^T v
      if (i0 < C) {
        float qs[CT][4];
#pragma unroll
        for (int t = 0; t < CT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) qs[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= nkd) break;
          const FragA fa =
              ld_a_rows_split(s.qd[0], s.qd[1], Sm::QP, i0, 8 * ks);
#pragma unroll
          for (int t = 0; t < CT; ++t)
            mma3(qs[t], fa, ld_b_cols_split(s.st[0], s.st[1], Sm::SP,
                                            c0 + 8 * t, 8 * ks));
        }
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          float* q = s.yq + (i0 + gr) * Sm::SP + c0 + 8 * t + 2 * tq;
          *reinterpret_cast<float2*>(q) = make_float2(qs[t][0], qs[t][1]);
          *reinterpret_cast<float2*>(q + 8 * Sm::SP) =
              make_float2(qs[t][2], qs[t][3]);
        }
      }
      if (16 * mt < dk) {
        const float l0 = s.cl[16 * mt + gr], l1 = s.cl[16 * mt + gr + 8];
#pragma unroll
        for (int t = 0; t < CT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[t][e] *= e < 2 ? l0 : l1;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= nk) break;
          const FragA fa =
              ld_a_cols_split(s.kr[0], s.kr[1], Sm::KRP, 16 * mt, 8 * ks);
#pragma unroll
          for (int t = 0; t < CT; ++t)
            mma_in<T>(st[t], fa, ld_b_cols(sg.v, Sm::VP, c0 + 8 * t, 8 * ks));
        }
      }
    }
    // X: q_dec S is in place for the readers, and no warp reads the old
    // state any more
    __syncthreads();
    if (reader && i0 < C) {
#pragma unroll
      for (int t = 0; t < CT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gr + 8 * (e >> 1);
          const int j = c0 + 8 * t + 2 * tq + (e & 1);
          if (i < C && j < nv)
            y[((size_t)b * S + c * C + i) * vstride + (size_t)h * dv + j0 +
              j] = acc[t][e] + s.yq[i * Sm::SP + j];
        }
    }
    if (!reader) {
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const int at = (16 * mt + gr) * Sm::SP + c0 + 8 * t + 2 * tq;
        store_split2(s.st[0], s.st[1], at, st[t][0], st[t][1]);
        store_split2(s.st[0], s.st[1], at + 8 * Sm::SP, st[t][2], st[t][3]);
      }
    }
  }

  if (reader) return;
#pragma unroll
  for (int t = 0; t < CT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 16 * mt + gr + 8 * (e >> 1);
      const int j = c0 + 8 * t + 2 * tq + (e & 1);
      if (kk < dk && j < nv) s_out[state + (size_t)kk * dv + j] = st[t][e];
    }
}

template <typename T, int VB, int WC>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B, int S,
           int H, int dk, int dv, int C, bool prefetch, cudaStream_t stream) {
  static bool configured[64] = {};
  auto kern = wkv6_chunk_kernel<T, VB, WC>;
  const int bytes = (int)sizeof(WkvSmem<T, VB, 256 * WC / KMAX>);
  const int e = allow_smem(kern, bytes, configured);
  if (e != 0) return e;
  // 16-byte copies need 16-byte aligned rows of r, k, w and of v's slices
  const int el = sizeof(T);
  const bool vec = aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(w) && (dk * el) % 16 == 0 && dk % 4 == 0 &&
                   (dv * el) % 16 == 0 && (VB * el) % 16 == 0;
  dim3 grid((dv + VB - 1) / VB, H, B), block(256 * WC);
  kern<<<grid, block, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H, dk, dv, C,
      vec, prefetch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k (B,S,H,dk) and v (B,S,H,dv) in T (bf16 or fp32); w (B,S,H,dk), u (H,dk),
// s0 (B,H,dk,dv) in fp32; outputs y (B,S,H,dv) and s_out (B,H,dk,dv) in fp32.
// All contiguous device pointers. ``design`` 0 lets the launcher choose the
// block shape: 32 of the dv columns a block. 1 and 2 force another (bf16
// only, for timing): 1 = the same without prefetch, 2 = 16 columns a
// block. Returns cudaGetLastError() after the launch, or -1 for a shape or
// design the kernel does not take.
extern "C" int repro_wkv6_chunk(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* y, void* s_out, int B, int S, int H,
                                int dk, int dv, int C, int is_bf16,
                                int design, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dk <= 0 || dv <= 0 || C <= 0 ||
      dk > KMAX || C > CMAX || S % C != 0 || B > 65535 || H > 65535 ||
      design < 0 || design > 2 || (!is_bf16 && design != 0))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WKV6_LAUNCH(T, VB, WC, PRE) \
  launch<T, VB, WC>(r, k, v, w, u, s0, y, s_out, B, S, H, dk, dv, C, PRE, st)
  if (!is_bf16) return REPRO_WKV6_LAUNCH(float, 32, 1, true);
  switch (design) {
    case 1: return REPRO_WKV6_LAUNCH(__nv_bfloat16, 32, 1, false);
    case 2: return REPRO_WKV6_LAUNCH(__nv_bfloat16, 16, 1, true);
    default:   // 32 columns measured fastest at rwkv6-7b's shape
      return REPRO_WKV6_LAUNCH(__nv_bfloat16, 32, 1, true);
  }
#undef REPRO_WKV6_LAUNCH
}
