// Prefill attention member: one prompt chunk (C query rows of one slot, at
// absolute offset off) against that slot's KV cache, causal, GQA; the cache
// contiguous or paged in the shared block arena.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py:40
// (prefill_attention_op, contiguous and block_table= forms).
//
// Bound on the card: operations.  A 512-row chunk does O(C) flops per cache
// byte: at offset 1024 and granite's widths 5.4 GFLOP against 9.4 MB of
// cache, q and outputs, far above the ridge.  Design: the tensor-core tile
// loop attn_mma (attention_mma.cuh): QK^T and P.V on mma.sync with fp32
// accumulation, the online softmax in registers, P split into two bf16
// terms so the fp32 output keeps the fp32 gate.  One CTA per (tile of
// RT = i[5] rows, KV head g), the rows in the order rr = cq * rep + r of the
// chunk's rep * C rows of that group, so each staged k/v tile serves every
// query head of the group; the kv loop stops at the tile's last causal
// position (off + last row), and the tiles of the latest rows, which read
// the most keys, run first.  The paged form looks each staged kv row up in
// the slot's table row: it differs from the contiguous form only in the
// load address, so both give the same bits, and so does any fused launch
// (each CTA's work is its own).
//
// Rows per CTA (kernels/prefill_attention.py ROWS_PER_CTA): 64, as 4 row
// groups of 16 whose two warp halves take alternate kv tiles and combine
// once at the end.  At C 512, rep 4 and 8 KV heads that is 256 CTAs: two per
// SM on 128 SMs, each warp reading half a tile's keys.  Measured on the H100
// against 128 rows a CTA (128 CTAs, one wave short of 132 SMs, each warp the
// whole kv range) in PERF.md.
//
// The member's body is a non-inlined call per head-dim class (D <= 64, D <=
// 128), so its code is not allocated with the other members' (inlined, it
// ran 11-17% faster on an H100 but spilled more in both bundle instances:
// PERF.md).
//
// Operands: off (1,1) i32; q (C,H,D) bf16; k, v (S,Hkv,D) bf16 ->
// o (C,H,D) f32 normalised, m, l (C,H,1) f32.  Paged (i[6] = bs > 0): k, v
// are the arena (num_blocks, bs, Hkv, D) and in[4] is the slot's table row
// bt (1, i[7]) i32.  Shared memory: amma_smem_bytes(RT, D), 81 KB at D 64
// and 85 KB at D 128 for 64 rows, above the 48 KB default: the launcher
// opts in.
#pragma once

#include "attention_mma.cuh"

// the rows of one KV head's group from flattened row fr0 (attn_mma's Rows)
struct PrefillRows {
  const bf16* q;
  float *o, *m, *l;
  int H, rep, D, off, fr0, g;
  __device__ size_t row(int i) const {
    const int fr = fr0 + i;
    return (size_t)(fr / rep) * H + g * rep + fr % rep;
  }
  __device__ const bf16* q_row(int i) const { return q + row(i) * D; }
  __device__ int lim(int i) const { return off + (fr0 + i) / rep + 1; }
  __device__ void store(size_t r, int d, float x, float y) const {
    *reinterpret_cast<float2*>(o + r * D + d) = make_float2(x, y);
  }
  __device__ void store_ml(size_t r, float mv, float lv) const {
    m[r] = mv;
    l[r] = lv;
  }
};

template <int DMAX>
__device__ __noinline__ void prefill_mma(const MemberDesc& md, int cta) {
  const int C = md.i[0], S = md.i[1], H = md.i[2], Hkv = md.i[3],
            D = md.i[4], RT = md.i[5], bs = md.i[6];
  const int rep = H / Hkv, nrows = C * rep;
  const int ntile = (nrows + RT - 1) / RT;
  const int t = ntile - 1 - cta / Hkv, g = cta % Hkv;   // latest rows first
  const int fr0 = t * RT, R = min(RT, nrows - fr0);
  const int off = *static_cast<const int*>(md.in[0]);
  const PrefillRows rows{static_cast<const bf16*>(md.in[1]),
                         static_cast<float*>(md.out[0]),
                         static_cast<float*>(md.out[1]),
                         static_cast<float*>(md.out[2]),
                         H, rep, D, off, fr0, g};
  const int n_kv = max(0, min(S, off + (fr0 + R - 1) / rep + 1));
  const bf16* k = static_cast<const bf16*>(md.in[2]) + (size_t)g * D;
  const bf16* v = static_cast<const bf16*>(md.in[3]) + (size_t)g * D;
  attn_mma<DMAX, amma_tkw(DMAX)>(
      rows, R, RT, D, n_kv, k, v, Hkv * D,
      bs ? static_cast<const int*>(md.in[4]) : nullptr, bs, md.f[0]);
}

__device__ void prefill_attn_member(const MemberDesc& md, int cta) {
  if (md.i[4] <= 64)
    prefill_mma<64>(md, cta);
  else
    prefill_mma<128>(md, cta);
}

__host__ __device__ inline int prefill_attn_smem_bytes(const MemberDesc& m) {
  return amma_smem_bytes(m.i[5], m.i[4]);
}
