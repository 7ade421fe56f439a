// Tensor-core attention tile loop: R query rows of one KV head against one
// sequence's cache, bf16 q, k, v, QK^T and P.V on mma.sync.m16n8k16 with fp32
// accumulation, the online softmax in fp32 registers.  Used by the bf16
// route of the standalone flash attention kernel (flash_attention.cuh) and
// by the prefill attention member (prefill_attention.cuh), contiguous and
// paged.  fp32 flash attention has an FFMA loop of its own
// (flash_attention.cuh flash_f32_kernel); decode attention has its own
// split-KV loop (decode_attention.cuh).
//
// The TPU kernels carry (m, l, acc) across sequential kv grid steps in VMEM
// (src/repro/kernels/flash_attention.py:21-50,
// src/repro/kernels/prefill_attention.py:85-119); CTAs run in no order, so
// here the carry is the kv loop inside one CTA, in registers.  Bound on the
// card: operations (a 512-row chunk or a train sequence does O(rows) flops
// per cache byte, far above the ridge).  The design is FlashAttention-2's:
//
// - Rows.  A CTA holds RT rows (a multiple of 16; RT / 16 divides the 8
//   warps), in the order rr = cq * rep + r (query position cq, head r of the
//   KV head's group), so each staged k/v row serves every query head of the
//   group.  The warps are G = RT / 16 row groups times KS = 8 / G kv parts:
//   warp w takes rows 16 * (w % G) .. + 15 and, of each staged tile of
//   KS * TKW keys, the TKW keys of part w / G.  With KS > 1 each warp's
//   (m, l, o) covers its part's keys; the parts are combined once, at the
//   end, in part order, through shared memory (no atomics, nothing across
//   CTAs, the same bits in any launch).
// - Staging.  Q (RT rows) once, then the k/v tiles double-buffered, all by
//   cp.async in 16-byte chunks.  Shared rows are DK + 8 bf16 apart (DK = D
//   rounded up to 16): the eight 16-byte rows an ldmatrix reads fall in
//   distinct bank groups.  The k/v row of position p is computed per staged
//   row, with the paged form's page-table lookup (row bt[p / bs] * bs +
//   p % bs, the reference's gather_pages): the paged and contiguous forms
//   differ only in the load address, so they give the same bits.  Positions
//   past n_kv and rows past R are zero-filled, and columns D..DK-1 of every
//   shared row are zeroed once, so the padded contraction adds exact zeros
//   to QK^T: D is any multiple of 8 up to 128.
// - S = QK^T.  Q fragments by ldmatrix, reloaded per 16-deep k step (kept in
//   registers they would cost 32 more at D 128), K fragments by ldmatrix.
//   bf16 x bf16 products are exact in fp32, and the scale multiplies the
//   fp32 score, s = scale * (q . k): one fp32 rounding away from the
//   reference's (q * scale) @ k^T.
// - Softmax.  Mask (-1e30 past the row's causal limit, as in the reference),
//   row max, exponentials and (m, l) stay in fp32 registers: a row's scores
//   of a chunk lie in one quad of the accumulator layout, so two shuffles
//   give its max; l is summed per thread and across the quad once, at the
//   end, with the reference's 1e-30 floor.  exp(x) is ex2.approx(x log2 e),
//   within ~1e-6 relative over the scores' range.
// - P.V.  Rounding P to bf16 for the second mma would cost up to 2^-9 of each
//   weight, beyond the fp32 gates the kernels are held to.  So P is split,
//   p_hi = bf16(p), p_lo = bf16(p - p_hi), into two mmas on the same fp32
//   accumulator: the residual is ~2^-17 p and V (bf16) is exact.  l sums the
//   unrounded p.  This is 1.5x the mma work of a single-P loop.
// - Causal.  The caller ends the kv loop at its last row's limit; a warp
//   skips a chunk wholly past all its rows' limits (exact: once a row has
//   seen position 0, such a chunk adds exp(-1e30 - m) = 0 with alpha = 1).
// - Registers.  A warp's 16 rows take DMAX / 2 o accumulators and TKW / 2
//   scores a thread: TKW is 64 keys at D <= 64 and 32 at D <= 128 (64 + 16
//   registers), so the loop fits 128 registers a thread, two CTAs an SM: as
//   a kernel without spills; as the bundle member's non-inlined body, whose
//   call takes a few registers, with a few words spilled outside the mma
//   work (ptxas's figures are in chip_smoke's build report).
#pragma once

#include "common.cuh"

#define AMMA_SKEW 8                       // bf16 pad of a shared row
#define AMMA_L2E 1.4426950408889634f      // log2 e

// the contraction padded to a multiple of 16; keys a warp takes per chunk
__host__ __device__ constexpr int amma_dk(int D) { return (D + 15) & ~15; }
__host__ __device__ constexpr int amma_tkw(int D) { return D <= 64 ? 64 : 32; }

// Dynamic shared memory of RT rows at head dim D: Q [RT][LD], k and v
// [2][KS * TKW][LD] bf16 (LD = DK + 8); the parts' combine (KS > 1) reuses
// the k/v stages.
__host__ __device__ inline int amma_smem_bytes(int RT, int D) {
  const int ld = amma_dk(D) + AMMA_SKEW, G = RT / 16, ks = HF_WARPS / G;
  const int kv = 2 * 4 * ks * amma_tkw(D) * ld;
  const int comb = 4 * (ks - 1) * G * (amma_dk(D) / 2 + 4) * 32;
  return 2 * RT * ld + (kv > comb ? kv : comb);
}

__device__ __forceinline__ float amma_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * AMMA_L2E));
  return y;
}

// (x, y) -> bf16 pairs hi = bf16(x, y), lo = bf16((x, y) - hi)
__device__ __forceinline__ void amma_split(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Rows r (0 <= r < R) of the CTA through `rows`: q_row(r) its query (D bf16),
// lim(r) the positions it admits (p < lim), row(r) its output row, and
// store(row, d, x, y) / store_ml(row, m, l) its normalised output and
// softmax statistics.  kbase / vbase point at cache row 0 of this KV head;
// cache rows are kv_stride elements apart; bt (null: contiguous) maps page
// p / bs to an arena block of bs rows.  Visits positions [0, n_kv).
template <int DMAX, int TKW, class Rows>
__device__ __forceinline__ void attn_mma(const Rows& rows, int R, int RT,
                                         int D, int n_kv, const bf16* kbase,
                                         const bf16* vbase, int kv_stride,
                                         const int* bt, int bs, float scale) {
  static_assert(DMAX % 16 == 0 && DMAX <= 128 && TKW % 16 == 0, "tiles");
  constexpr int NJ = TKW / 8;     // score n-tiles of a chunk
  constexpr int NO = DMAX / 8;    // output d-tiles
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = RT / 16, KS = HF_WARPS / G, TS = KS * TKW;
  const int rg = warp % G, kp = warp / G;
  const int DK = amma_dk(D), LD = DK + AMMA_SKEW, nk16 = DK / 16;
  const int vpr = D / 8;                      // 16-byte chunks of a row
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + RT * LD;                    // [2][TS][LD]
  bf16* vs = ks + 2 * TS * LD;                // [2][TS][LD]

  if (DK != D)                                // one 16-byte pad per row
    for (int r = tid; r < RT + 4 * TS; r += HF_THREADS)
      *reinterpret_cast<uint4*>(qs + r * LD + D) = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < RT * vpr; idx += HF_THREADS) {
    const int i = idx / vpr, c = (idx - i * vpr) * 8;
    const bool ok = i < R;
    cp_async16(qs + i * LD + c, ok ? rows.q_row(i) + c : kbase, ok);
  }
  // stage st: positions st * TS .. + TS - 1 into buffer st & 1 (one group)
  auto stage = [&](int st) {
    bf16* kd = ks + (st & 1) * TS * LD;
    bf16* vd = vs + (st & 1) * TS * LD;
    for (int idx = tid; idx < TS * vpr; idx += HF_THREADS) {
      const int j = idx / vpr, c = (idx - j * vpr) * 8;
      const int p = st * TS + j;
      const bool ok = p < n_kv;
      size_t at = 0;
      if (ok) at = (size_t)(bt ? bt[p / bs] * bs + p % bs : p) * kv_stride + c;
      cp_async16(kd + j * LD + c, kbase + at, ok);
      cp_async16(vd + j * LD + c, vbase + at, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // this thread's rows of the warp's 16: gid and gid + 8
  const int r0 = rg * 16 + gid, r1 = r0 + 8;
  const int lim0 = r0 < R ? max(0, min(rows.lim(r0), n_kv)) : 0;
  const int lim1 = r1 < R ? max(0, min(rows.lim(r1), n_kv)) : 0;
  const int wlim = (int)__reduce_max_sync(FULL, (unsigned)max(lim0, lim1));
  float m0 = HF_NEG_INF, m1 = HF_NEG_INF, l0 = 0.0f, l1 = 0.0f;
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  const int nst = (n_kv + TS - 1) / TS;
  stage(0);                                   // Q rides in the first group
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) {
      stage(st + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int p0 = st * TS + kp * TKW;        // this warp's chunk
    if (p0 < wlim) {
      const bf16* kc = ks + ((st & 1) * TS + kp * TKW) * LD;
      const bf16* vc = vs + ((st & 1) * TS + kp * TKW) * LD;
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk < nk16) {
          uint32_t a[4];
          ldsm_x4(a, qs + (rg * 16 + (lane & 15)) * LD + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
          for (int j2 = 0; j2 < NJ / 2; ++j2) {
            uint32_t b[4];
            ldsm_x4(b, kc + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16_16816(s[2 * j2], a, b);
            mma_bf16_16816(s[2 * j2 + 1], a, b + 2);
          }
        }
      }
      // score (j, e): row gid (+8 for e >= 2), key p0 + 8j + 2 tig + (e & 1)
      float mx0 = HF_NEG_INF, mx1 = HF_NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = p0 + j * 8 + tig * 2;
        s[j][0] = key < lim0 ? s[j][0] * scale : HF_NEG_INF;
        s[j][1] = key + 1 < lim0 ? s[j][1] * scale : HF_NEG_INF;
        s[j][2] = key < lim1 ? s[j][2] * scale : HF_NEG_INF;
        s[j][3] = key + 1 < lim1 ? s[j][3] * scale : HF_NEG_INF;
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = amma_exp(m0 - mn0), al1 = amma_exp(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = amma_exp(s[j][0] - mn0);
        s[j][1] = amma_exp(s[j][1] - mn0);
        s[j][2] = amma_exp(s[j][2] - mn1);
        s[j][3] = amma_exp(s[j][3] - mn1);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (j < 2 * nk16) {
          o[j][0] *= al0;
          o[j][1] *= al0;
          o[j][2] *= al1;
          o[j][3] *= al1;
        }
      }
      // P (16 x 16 per k step) in the A layout from the score registers
#pragma unroll
      for (int kk = 0; kk < TKW / 16; ++kk) {
        uint32_t hi[4], lo[4];
        amma_split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        amma_split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        amma_split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        amma_split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int d2 = 0; d2 < DMAX / 16; ++d2) {
          if (d2 < nk16) {
            uint32_t b[4];
            ldsm_x4_trans(b, vc + (kk * 16 + (lane & 15)) * LD + d2 * 16 +
                                 (lane >> 4) * 8);
            mma_bf16_16816(o[2 * d2], hi, b);
            mma_bf16_16816(o[2 * d2], lo, b);
            mma_bf16_16816(o[2 * d2 + 1], hi, b + 2);
            mma_bf16_16816(o[2 * d2 + 1], lo, b + 2);
          }
        }
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);

  if (KS > 1) {   // parts 1..KS-1 into part 0, in order, over the k/v stages
    float* cb = reinterpret_cast<float*>(ks);
    const int per = (4 + 8 * nk16) * 32;      // floats of one warp's part
    __syncthreads();
    if (kp > 0) {
      float* dst = cb + ((kp - 1) * G + rg) * per + lane;
      dst[0] = m0;
      dst[32] = m1;
      dst[64] = l0;
      dst[96] = l1;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        if (j < 2 * nk16)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(4 + 4 * j + e) * 32] = o[j][e];
    }
    __syncthreads();
    if (kp == 0) {
      for (int q = 1; q < KS; ++q) {
        const float* src = cb + ((q - 1) * G + rg) * per + lane;
        const float mt0 = fmaxf(m0, src[0]), mt1 = fmaxf(m1, src[32]);
        const float fa0 = amma_exp(m0 - mt0), fb0 = amma_exp(src[0] - mt0);
        const float fa1 = amma_exp(m1 - mt1), fb1 = amma_exp(src[32] - mt1);
        l0 = l0 * fa0 + src[64] * fb0;
        l1 = l1 * fa1 + src[96] * fb1;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          if (j < 2 * nk16) {
            o[j][0] = o[j][0] * fa0 + src[(4 + 4 * j) * 32] * fb0;
            o[j][1] = o[j][1] * fa0 + src[(5 + 4 * j) * 32] * fb0;
            o[j][2] = o[j][2] * fa1 + src[(6 + 4 * j) * 32] * fb1;
            o[j][3] = o[j][3] * fa1 + src[(7 + 4 * j) * 32] * fb1;
          }
        }
        m0 = mt0;
        m1 = mt1;
      }
    }
  }

  if (kp == 0) {
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const bool ok0 = r0 < R, ok1 = r1 < R;
    const size_t w0 = ok0 ? rows.row(r0) : 0, w1 = ok1 ? rows.row(r1) : 0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      if (j < vpr) {
        const int d = j * 8 + tig * 2;
        if (ok0) rows.store(w0, d, o[j][0] / d0, o[j][1] / d0);
        if (ok1) rows.store(w1, d, o[j][2] / d1, o[j][3] / d1);
      }
    }
    if (tig == 0) {
      if (ok0) rows.store_ml(w0, m0, l0);
      if (ok1) rows.store_ml(w1, m1, l1);
    }
  }
}
