// Decode attention member: one new query token per slot against that slot's
// KV cache, GQA, per-slot valid length; the cache contiguous per slot or
// paged in a block arena the slots share.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:44
// (decode_attention_op, dynamic_length=True, contiguous and block_table=
// forms; :35 gather_pages becomes the row lookup in attn_loop).
//
// Bound on the card: bytes.  It streams each slot's valid cache prefix
// (2 * len * Hkv * D * 2 bytes per slot) and does O(D) flops per byte.
// Design: one CTA per (slot b, KV head g) holds that head's rep = H/Hkv query
// rows, so each cached k/v row is read from device memory once for all the
// query heads that share it; the loop stops at the slot's own length, so
// short slots cost only what they hold.  Not yet: split-KV across CTAs
// (64 CTAs at B=8, Hkv=8 leave most of the 132 SMs idle) and overlapping the
// next tile's load with this tile's math.
//
// Operands: len (B,1) i32; q (B,H,D) bf16; k, v (B,S,Hkv,D) bf16 ->
// o (B,H,D) f32 normalised, m, l (B,H,1) f32.  Paged (i[5] = bs > 0): k, v
// are the arena (num_blocks, bs, Hkv, D) and in[4] is bt (B, i[6]) i32, slot
// b's page -> arena block.  Blocks 0..B-1 are the slots' sentinels: an idle
// or masked slot's table row points at its own, never at another slot's.
#pragma once

#include "attention_core.cuh"

__device__ void decode_attn_member(const MemberDesc& md, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = md.i[1], H = md.i[2], Hkv = md.i[3], D = md.i[4];
  const float scale = md.f[0];
  const int rep = H / Hkv;
  const int b = cta / Hkv, g = cta % Hkv;
  const int* len = static_cast<const int*>(md.in[0]);
  const bf16* q = static_cast<const bf16*>(md.in[1]);
  const bf16* k = static_cast<const bf16*>(md.in[2]);
  const bf16* v = static_cast<const bf16*>(md.in[3]);
  float* o = static_cast<float*>(md.out[0]);
  float* mo = static_cast<float*>(md.out[1]);
  float* lo = static_cast<float*>(md.out[2]);

  const int R = rep;
  AttnSmem sm = attn_smem(smem, R, D);
  const int L = len[b];
  // a slot with no valid position masks every score, as the reference
  // does, and then averages the whole cache exactly like it
  const int n_kv = L <= 0 ? S : min(L, S);
  const size_t qrow0 = (size_t)b * H + (size_t)g * rep;
  for (int idx = threadIdx.x; idx < R * D; idx += HF_THREADS) {
    sm.q[idx] = bf2f(q[qrow0 * D + idx]) * scale;
    sm.o[idx] = 0.0f;
  }
  for (int r = threadIdx.x; r < R; r += HF_THREADS) {
    sm.m[r] = HF_NEG_INF;
    sm.l[r] = 0.0f;
    sm.lim[r] = L;
  }
  __syncthreads();

  const int bs = md.i[5];
  const int* bt = bs ? static_cast<const int*>(md.in[4]) + (size_t)b * md.i[6]
                     : nullptr;
  const size_t base = ((bs ? 0 : (size_t)b * S * Hkv) + g) * D;
  attn_loop(sm, R, D, n_kv, k + base, v + base, Hkv * D, bt, bs);

  for (int idx = threadIdx.x; idx < R * D; idx += HF_THREADS) {
    const int r = idx / D;
    o[qrow0 * D + idx] = sm.o[idx] / fmaxf(sm.l[r], 1e-30f);
  }
  for (int r = threadIdx.x; r < R; r += HF_THREADS) {
    mo[qrow0 + r] = sm.m[r];
    lo[qrow0 + r] = sm.l[r];
  }
}

__host__ __device__ inline int decode_attn_smem_bytes(const MemberDesc& m) {
  return attn_smem_bytes(m.i[2] / m.i[3], m.i[4]);
}
