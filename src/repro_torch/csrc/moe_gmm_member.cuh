// Grouped expert FFN member (MoE): E expert FFNs in one launch, the
// framework's own instance of horizontal fusion.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:54 (moe_gmm_op, and
// :34 moe_gmm, the same member launched alone).  Per expert e:
//   h  = act(gate) * up  with [gate | up] = xe[e] @ w_in[e]   (fp32 sums)
//   ye = bf16(bf16(h) @ w_out[e])                               (fp32 sums)
// as _gmm_kernel (:21-31) computes it: the activation in fp32 on the
// unrounded product, h rounded to bf16 before the second product.
//
// Bound on the card: bytes.  At decode (C = 8 rows per expert) it streams all
// E experts' weights once (2.52 GB at phi3.5-moe: 16 x 4096 x 12800 + 16 x
// 6400 x 4096 bf16) and does 2 * C flops per weight element.  The TPU grid
// runs one step per (expert, row block); one CTA per expert would leave 116
// of the 132 SMs idle.  So a CTA owns one f-tile of FT (256) hidden columns
// of one expert: it streams the tile's gate and up columns of w_in, forms h
// for the tile in shared memory, rounds it to bf16 and streams the tile's FT
// rows of w_out into a (C, d) fp32 partial: E * f / FT CTAs (400 at
// phi3.5-moe).  Rows run in blocks of 8 (the row GEMM's accumulators): a
// capacity above 8 streams the tile once per block.
//
// The partials cross CTAs as in the paper members' carries: each CTA writes
// its partial into a per-launch workspace, takes a ticket of its expert
// after __threadfence(), and the expert's last CTA sums the f-tiles' partials
// in tile order and stores ye.  No waits, no float atomics: a fused launch is
// bitwise equal to the member launched alone.  The workspace is E * f / FT *
// C * d fp32 (52 MB at decode, 4% over the weight stream).
//
// Descriptor: i[0] = E, i[1] = C, i[2] = d, i[3] = f, i[4] = FT, i[5] = act
// (row_member.cuh: 0 silu-gated, 1 gelu-gated, 2 gelu).  in = xe (E,C,d),
// w_in (E,d,2f or f), w_out (E,f,d) bf16; out[0] = ye (E,C,d) bf16, out[1] =
// the partials, out[2] = E tickets (int, zeroed).
#pragma once

#include "row_member.cuh"

#define GMM_MB GEMM_MB      // rows per block (the accumulators of gemm_fma)
#define GMM_RED 2048        // floats of the k-residue fold buffer

// shared memory: xs [8*d] bf16 | red [2048] f32 | hpre [8*n1] f32 | hb [8*FT]
__host__ __device__ inline int gmm_smem_bytes(const MemberDesc& m) {
  const int d = m.i[2], ft = m.i[4];
  const int n1 = act_gated(m.i[5]) ? 2 * ft : ft;
  return hf_align16(GMM_MB * d * 2) + 4 * (GMM_RED + GMM_MB * n1 + GMM_MB * ft);
}

__device__ void moe_gmm_member(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = m.i[1], d = m.i[2], f = m.i[3], ft = m.i[4], act = m.i[5];
  const bool gated = act_gated(act);
  const int fin = gated ? 2 * f : f;
  const int n1 = gated ? 2 * ft : ft;       // w_in columns of the tile
  const int T = f / ft;                     // f-tiles (CTAs) per expert
  const int e = cta / T, t = cta % T;
  const bf16* xe = static_cast<const bf16*>(m.in[0]) + (size_t)e * C * d;
  const bf16* win = static_cast<const bf16*>(m.in[1]) + (size_t)e * d * fin;
  const bf16* wout = static_cast<const bf16*>(m.in[2]) +
                     ((size_t)e * f + (size_t)t * ft) * d;
  float* part = static_cast<float*>(m.out[1]) + (size_t)e * T * C * d;

  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + hf_align16(GMM_MB * d * 2));
  float* hpre = red + GMM_RED;
  float* hb = hpre + GMM_MB * n1;

  const int tid = threadIdx.x;
  const int ncg = n1 / 8;                   // 8-column groups of the tile
  const int nkr = HF_THREADS / ncg;         // k residues
  const int cg = tid % ncg, kr = tid / ncg;
  int col0 = t * ft + cg * 8;               // this thread's w_in columns
  if (gated && cg >= ncg / 2) col0 = f + t * ft + (cg - ncg / 2) * 8;

  for (int m0 = 0; m0 < C; m0 += GMM_MB) {
    const int mb = min(GMM_MB, C - m0);
    for (int v = tid; v < mb * d / 8; v += HF_THREADS)
      reinterpret_cast<uint4*>(xs)[v] =
          reinterpret_cast<const uint4*>(xe + (size_t)m0 * d)[v];
    __syncthreads();

    // 1. [gate | up] of the tile: k ascends, so each column's sum runs in
    // one fixed order
    float acc[GMM_MB][8];
#pragma unroll
    for (int r = 0; r < GMM_MB; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
    int k = kr;
    for (; k + 3 * nkr < d; k += 4 * nkr) {
      uint4 w0 = *reinterpret_cast<const uint4*>(win + (size_t)k * fin + col0);
      uint4 w1 = *reinterpret_cast<const uint4*>(
          win + (size_t)(k + nkr) * fin + col0);
      uint4 w2 = *reinterpret_cast<const uint4*>(
          win + (size_t)(k + 2 * nkr) * fin + col0);
      uint4 w3 = *reinterpret_cast<const uint4*>(
          win + (size_t)(k + 3 * nkr) * fin + col0);
      gemm_fma(acc, xs, d, k, mb, w0);
      gemm_fma(acc, xs, d, k + nkr, mb, w1);
      gemm_fma(acc, xs, d, k + 2 * nkr, mb, w2);
      gemm_fma(acc, xs, d, k + 3 * nkr, mb, w3);
    }
    for (; k < d; k += nkr) {
      uint4 w0 = *reinterpret_cast<const uint4*>(win + (size_t)k * fin + col0);
      gemm_fma(acc, xs, d, k, mb, w0);
    }
    // fold the k residues in residue order, one row at a time
#pragma unroll
    for (int r = 0; r < GMM_MB; ++r) {
      if (r < mb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) red[kr * n1 + cg * 8 + j] = acc[r][j];
        __syncthreads();
        for (int c = tid; c < n1; c += HF_THREADS) {
          float s = 0.0f;
          for (int q = 0; q < nkr; ++q) s += red[q * n1 + c];
          hpre[r * n1 + c] = s;
        }
        __syncthreads();
      }
    }
    // the activation in fp32, h rounded to bf16
    for (int idx = tid; idx < mb * ft; idx += HF_THREADS) {
      const int r = idx / ft, j = idx % ft;
      const float a = hpre[r * n1 + j];
      const float b = gated ? hpre[r * n1 + ft + j] : 0.0f;
      hb[idx] = bf_round(act_apply(act, a, b));
    }
    __syncthreads();

    // 2. the tile's partial of ye: h (mb, FT) @ w_out tile (FT, d)
    for (int v = tid; v < d / 8; v += HF_THREADS) {
      float acc2[GMM_MB][8];
#pragma unroll
      for (int r = 0; r < GMM_MB; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc2[r][q] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < ft; ++j) {
        float wf[8];
        unpack8(*reinterpret_cast<const uint4*>(wout + (size_t)j * d + v * 8),
                wf);
#pragma unroll
        for (int r = 0; r < GMM_MB; ++r) {
          if (r < mb) {
            const float hv = hb[r * ft + j];
#pragma unroll
            for (int q = 0; q < 8; ++q) acc2[r][q] = fmaf(hv, wf[q], acc2[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < GMM_MB; ++r) {
        if (r < mb) {
          float4* dst = reinterpret_cast<float4*>(
              part + ((size_t)t * C + m0 + r) * d + v * 8);
          dst[0] = make_float4(acc2[r][0], acc2[r][1], acc2[r][2], acc2[r][3]);
          dst[1] = make_float4(acc2[r][4], acc2[r][5], acc2[r][6], acc2[r][7]);
        }
      }
    }
    __syncthreads();
  }

  // 3. the expert's last CTA sums the T partials in tile order
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), e, T)) return;
  bf16* ye = static_cast<bf16*>(m.out[0]) + (size_t)e * C * d;
  const size_t stride = (size_t)C * d / 4;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (size_t idx = tid; idx < stride; idx += HF_THREADS) {
    float4 s = p4[idx];
    for (int q = 1; q < T; ++q) {
      const float4 a = p4[q * stride + idx];
      s.x += a.x;
      s.y += a.y;
      s.z += a.z;
      s.w += a.w;
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ye + idx * 4);
    dst[0] = __floats2bfloat162_rn(s.x, s.y);
    dst[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}
