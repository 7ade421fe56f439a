// Prefill attention member: one prompt chunk (C query rows of one slot, at
// absolute offset off) against that slot's KV cache, causal, GQA; the cache
// contiguous or paged in the shared block arena.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py:40
// (prefill_attention_op, contiguous and block_table= forms).
//
// Bound on the card: operations.  A 512-row chunk does O(C) flops per cache
// byte (about 8.6 GFLOP against 2 MB of a 2048-row cache per layer before
// causal pruning), above the ridge.  Design: one CTA per (tile of QT query
// rows, KV head g) holds QT * rep rows (32 at granite's rep 4), so each
// staged k/v tile serves every query head of the group; the kv loop stops at
// the tile's last causal position (off + last row), so causal pruning is per
// CTA.  The math is fp32 on the CUDA cores: tensor cores (wgmma) are the
// next step for this member.
//
// Operands: off (1,1) i32; q (C,H,D) bf16; k, v (S,Hkv,D) bf16 ->
// o (C,H,D) f32 normalised, m, l (C,H,1) f32.  Paged (i[6] = bs > 0): k, v
// are the arena (num_blocks, bs, Hkv, D) and in[4] is the slot's table row
// bt (1, i[7]) i32.  At head dim 128 and rep 4 a CTA holds 32 rows in ~74 KB
// of shared memory, above the 48 KB default: the launcher opts in.
#pragma once

#include "attention_core.cuh"

__device__ void prefill_attn_member(const MemberDesc& md, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = md.i[0], S = md.i[1], H = md.i[2], Hkv = md.i[3],
            D = md.i[4], QT = md.i[5];
  const float scale = md.f[0];
  const int rep = H / Hkv;
  const int t = cta / Hkv, g = cta % Hkv;
  const int c0 = t * QT;
  const int nq = min(QT, C - c0);
  const int off = *static_cast<const int*>(md.in[0]);
  const bf16* q = static_cast<const bf16*>(md.in[1]);
  const bf16* k = static_cast<const bf16*>(md.in[2]);
  const bf16* v = static_cast<const bf16*>(md.in[3]);
  float* o = static_cast<float*>(md.out[0]);
  float* mo = static_cast<float*>(md.out[1]);
  float* lo = static_cast<float*>(md.out[2]);

  const int R = nq * rep;                   // row rr = cq * rep + r
  AttnSmem sm = attn_smem(smem, QT * rep, D);
  for (int idx = threadIdx.x; idx < R * D; idx += HF_THREADS) {
    const int rr = idx / D, d = idx % D;
    const int cq = rr / rep, r = rr % rep;
    sm.q[idx] = bf2f(q[((size_t)(c0 + cq) * H + g * rep + r) * D + d]) * scale;
    sm.o[idx] = 0.0f;
  }
  for (int rr = threadIdx.x; rr < R; rr += HF_THREADS) {
    sm.m[rr] = HF_NEG_INF;
    sm.l[rr] = 0.0f;
    sm.lim[rr] = off + c0 + rr / rep + 1;   // kpos <= off + row
  }
  __syncthreads();

  const int n_kv = max(0, min(S, off + c0 + nq));
  const int bs = md.i[6];
  attn_loop(sm, R, D, n_kv, k + (size_t)g * D, v + (size_t)g * D, Hkv * D,
            bs ? static_cast<const int*>(md.in[4]) : nullptr, bs);

  for (int idx = threadIdx.x; idx < R * D; idx += HF_THREADS) {
    const int rr = idx / D, d = idx % D;
    const int cq = rr / rep, r = rr % rep;
    o[((size_t)(c0 + cq) * H + g * rep + r) * D + d] =
        sm.o[idx] / fmaxf(sm.l[rr], 1e-30f);
  }
  for (int rr = threadIdx.x; rr < R; rr += HF_THREADS) {
    const size_t row = (size_t)(c0 + rr / rep) * H + g * rep + rr % rep;
    mo[row] = sm.m[rr];
    lo[row] = sm.l[rr];
  }
}

__host__ __device__ inline int prefill_attn_smem_bytes(const MemberDesc& m) {
  return attn_smem_bytes(m.i[5] * (m.i[2] / m.i[3]), m.i[4]);
}
