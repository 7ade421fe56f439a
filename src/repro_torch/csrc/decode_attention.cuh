// Decode attention member: one new query token per slot against that slot's
// KV cache, GQA, per-slot valid length; the cache contiguous per slot or
// paged in a block arena the slots share.  Split-KV: the cache's positions
// are cut into fixed ranges, one CTA each, combined by the slot's last CTA.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:44
// (decode_attention_op: the per-slot dynamic_length=True form, and the
// static forms, a fixed `length` or the whole cache, where every slot's
// valid length is the launch constant i[8]; contiguous and block_table=
// forms; :35 gather_pages becomes the row lookup of the staging loop).
//
// Bound on the card: bytes.  It streams each slot's valid cache prefix
// (2 * len * Hkv * D * 2 bytes per slot) and does O(D) flops per byte, so
// what counts is how many bytes are in flight at once.  Design:
//
// - Splits.  Positions [0, S) are cut into ranges of KS = i[7] positions
//   (kernels/decode_attention.py kv_split: 256, or a multiple of the page
//   size; whole pages and whole warp tiles).  One CTA per (slot b, KV head
//   g, split): B * Hkv * ceil(S / KS) CTAs, 512 at B 8, Hkv 8, S 2048
//   against 64 with one CTA per (slot, head).  KS comes from S and the page
//   size, never from the live lengths, so a planned launch's CTA count is
//   static.  A split wholly past its slot's length exits at once (its empty
//   partial, m = -1e30, l = 0, would add exact zeros to the combine, so the
//   combine counts only the live splits); a slot of length <= 0 masks every
//   score and, as the reference's all-masked row, averages the whole cache:
//   every split of it takes part.
// - Combine.  A slot with one live split writes o, m, l itself.  Otherwise
//   each live split writes its (o unnormalised, m, l) into the per-launch
//   workspace (out[3]) and takes a ticket of its (slot, head) after
//   __threadfence(); the last CTA combines the splits in split order:
//   m = max m_i, l = sum l_i e^(m_i - m), o = sum o_i e^(m_i - m) / max(l,
//   1e-30).  No waits and no float atomics: any launch (fused or alone)
//   gives the same bits, and the paged form, whose splits and arithmetic
//   order are the contiguous form's with another row address, gives the
//   contiguous form's bits.
// - The loop.  The group's rep = H / Hkv query rows are taken DEC_RB at a
//   time (one pass; more passes re-read the split, rep > 4 only), their
//   queries in registers as bf16 (bf16 x bf16 products are exact in fp32;
//   the scale multiplies the fp32 score, one rounding from the reference's
//   (q * scale) . k).  LPP lanes share a cached row, 8 of its D
//   elements each (LPP = 8 at D <= 64, 16 at <= 128, 32 at <= 256), so a
//   warp takes NP = 32 / LPP positions at a time; dot products reduce over
//   the LPP lanes by shuffles.  Each warp stages its own tiles of DEC_J * NP
//   positions (k and v rows, 16-byte cp.async, double-buffered in its own
//   slice of shared memory, so only __syncwarp() guards a tile: no CTA
//   barrier and no score tile in shared memory).  Each lane group keeps its
//   own online-softmax state (m, l per row, o for its 8 elements per row),
//   updated per position; at the CTA's end the 8 * NP states are combined in
//   a fixed order through shared memory.
//
// The body is a non-inlined call: code inlined into hf_bundle moves every
// other member's register allocation (PERF.md).
//
// Operands: len (B,1) i32 (in[0]; null in the static forms, which read
// the length from i[8]); q (B,H,D) bf16; k, v (B,S,Hkv,D) bf16 ->
// o (B,H,D) f32 normalised, m, l (B,H,1) f32.  Paged (i[5] = bs > 0): k, v
// are the arena (num_blocks, bs, Hkv, D) and in[4] is bt (B, i[6]) i32, slot
// b's page -> arena block.  Blocks 0..B-1 are the slots' sentinels: an idle
// or masked slot's table row points at its own, never at another slot's.
// out[3]: the workspace, B * Hkv tickets (int, zeroed) then per (slot,
// head, split, row) the partial o (D floats) and (m, l).
#pragma once

#include "common.cuh"

#define DEC_RB 4        // query rows of a pass (registers)
#define DEC_J 4         // positions a lane group takes from one warp tile
#define DEC_STAGES 2    // warp tiles in flight per warp

// lanes that share one cached row, 8 elements each
__host__ __device__ inline int dec_lpp(int D) {
  return D <= 64 ? 8 : D <= 128 ? 16 : 32;
}

// per warp: DEC_STAGES tiles of DEC_J * NP positions' k and v rows (D bf16)
__host__ __device__ inline int decode_attn_smem_bytes(const MemberDesc& m) {
  const int D = m.i[4], np = 32 / dec_lpp(D);
  return HF_WARPS * DEC_STAGES * DEC_J * np * D * 2 * 2;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __noinline__ void decode_split(const MemberDesc& md, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = md.i[0], S = md.i[1], H = md.i[2], Hkv = md.i[3],
            D = md.i[4], bs = md.i[5], KS = md.i[7];
  const float scale = md.f[0];
  const int rep = H / Hkv, nsp = (S + KS - 1) / KS;
  const int sp = cta % nsp, grp = cta / nsp, b = grp / Hkv, g = grp % Hkv;
  const int L = md.in[0] ? static_cast<const int*>(md.in[0])[b] : md.i[8];
  const int n_kv = L <= 0 ? S : min(L, S);
  const int live = (n_kv + KS - 1) / KS;
  if (sp >= live) return;                   // wholly past the slot's length
  const int pb = sp * KS, pe = min(pb + KS, n_kv);
  const bf16* q = static_cast<const bf16*>(md.in[1]);
  const int* bt = bs ? static_cast<const int*>(md.in[4]) + (size_t)b * md.i[6]
                     : nullptr;
  const size_t base = ((bs ? 0 : (size_t)b * S * Hkv) + g) * D;
  const bf16* kb = static_cast<const bf16*>(md.in[2]) + base;
  const bf16* vb = static_cast<const bf16*>(md.in[3]) + base;
  const int kv_stride = Hkv * D;
  float* o_out = static_cast<float*>(md.out[0]);
  float* m_out = static_cast<float*>(md.out[1]);
  float* l_out = static_cast<float*>(md.out[2]);
  int* tickets = static_cast<int*>(md.out[3]);
  float* ws = static_cast<float*>(md.out[3]) + ((B * Hkv + 3) & ~3);
  const size_t qrow0 = (size_t)b * H + (size_t)g * rep;
  // this (slot, head, split)'s partial: o [rep][D] then (m, l) [rep][2]
  const size_t part = ((size_t)grp * nsp + sp) * rep * (D + 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpp = dec_lpp(D), np = 32 / lpp, wt = DEC_J * np;
  const int pg = lane / lpp, c = lane % lpp, vpr = D / 8;
  const bool has = c < vpr;                 // holds 8 elements of the row
  bf16* wbuf = reinterpret_cast<bf16*>(smem) +
               (size_t)warp * DEC_STAGES * wt * D * 2;
  const int ntile = (pe - pb + wt - 1) / wt;
  const int mine = ntile > warp ? (ntile - warp + HF_WARPS - 1) / HF_WARPS : 0;

  // this warp's i-th tile (tile warp + 8 i of the split) into stage i & 1
  auto stage = [&](int i) {
    bf16* kd = wbuf + (i & 1) * wt * D * 2;
    bf16* vd = kd + wt * D;
    const int p0 = pb + (warp + HF_WARPS * i) * wt;
    for (int idx = lane; idx < wt * vpr; idx += 32) {
      const int j = idx / vpr, cc = idx - j * vpr;
      const int p = p0 + j;
      const bool ok = p < pe;
      size_t at = 0;
      if (ok)
        at = (size_t)(bt ? bt[p / bs] * bs + p % bs : p) * kv_stride + cc * 8;
      cp_async16(kd + j * D + cc * 8, kb + at, ok);
      cp_async16(vd + j * D + cc * 8, vb + at, ok);
    }
    cp_async_commit();
  };

  const int NS = HF_WARPS * np;             // lane-group states of the CTA
  for (int r0 = 0; r0 < rep; r0 += DEC_RB) {
    uint4 qv[DEC_RB];                       // 8 bf16 of each query row
    float o[DEC_RB][8], m[DEC_RB], l[DEC_RB];
#pragma unroll
    for (int r = 0; r < DEC_RB; ++r) {
      m[r] = HF_NEG_INF;
      l[r] = 0.0f;
      qv[r] = has && r0 + r < rep
                  ? *reinterpret_cast<const uint4*>(
                        q + (qrow0 + r0 + r) * D + c * 8)
                  : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[r][e] = 0.0f;
    }

    if (mine > 0) stage(0);
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage(i + 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncwarp();
      const bf16* kt = wbuf + (i & 1) * wt * D * 2;
      const bf16* vt = kt + wt * D;
      const int n_here = pe - (pb + (warp + HF_WARPS * i) * wt);
#pragma unroll 1
      for (int jj = 0; jj < DEC_J; ++jj) {
        const int j = jj * np + pg;
        const bool present = j < n_here;    // uniform over the lane group
        float kf[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (has)
          unpack8(*reinterpret_cast<const uint4*>(kt + j * D + c * 8), kf);
        float s[DEC_RB];
#pragma unroll
        for (int r = 0; r < DEC_RB; ++r) {
          const __nv_bfloat162* qh =
              reinterpret_cast<const __nv_bfloat162*>(&qv[r]);
          float a = 0.0f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 qq = __bfloat1622float2(qh[e]);
            a = fmaf(qq.x, kf[2 * e], a);
            a = fmaf(qq.y, kf[2 * e + 1], a);
          }
          for (int x = lpp / 2; x > 0; x >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, x);
          s[r] = L <= 0 ? HF_NEG_INF : a * scale;   // every score masked
        }
        if (!present) continue;
        float vf[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (has)
          unpack8(*reinterpret_cast<const uint4*>(vt + j * D + c * 8), vf);
#pragma unroll
        for (int r = 0; r < DEC_RB; ++r) {
          const float mn = fmaxf(m[r], s[r]);
          const float alpha = expf(m[r] - mn), p = expf(s[r] - mn);
          m[r] = mn;
          l[r] = l[r] * alpha + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) o[r][e] = fmaf(p, vf[e], o[r][e] * alpha);
        }
      }
      __syncwarp();                         // the stage is free again
    }

    // the NS lane-group states into one, in state order
    __syncthreads();
    float* st_m = reinterpret_cast<float*>(smem);       // [NS][RB]
    float* st_l = st_m + NS * DEC_RB;                    // [NS][RB]
    float* fac = st_l + NS * DEC_RB;                     // [NS][RB]
    float* tot = fac + NS * DEC_RB;                      // M [RB], L [RB]
    float* st_o = tot + 2 * DEC_RB;                      // [NS][RB][D]
    const int sidx = warp * np + pg;
    if (c == 0)
#pragma unroll
      for (int r = 0; r < DEC_RB; ++r) {
        st_m[sidx * DEC_RB + r] = m[r];
        st_l[sidx * DEC_RB + r] = l[r];
      }
    if (has)
#pragma unroll
      for (int r = 0; r < DEC_RB; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          st_o[(sidx * DEC_RB + r) * D + c * 8 + e] = o[r][e];
    __syncthreads();
    if (tid < DEC_RB) {
      float M = HF_NEG_INF, Lsum = 0.0f;
      for (int s = 0; s < NS; ++s) M = fmaxf(M, st_m[s * DEC_RB + tid]);
      for (int s = 0; s < NS; ++s) {
        const float f = expf(st_m[s * DEC_RB + tid] - M);
        fac[s * DEC_RB + tid] = f;
        Lsum += st_l[s * DEC_RB + tid] * f;
      }
      tot[tid] = M;
      tot[DEC_RB + tid] = Lsum;
    }
    __syncthreads();
    for (int idx = tid; idx < DEC_RB * D; idx += HF_THREADS) {
      const int r = idx / D, d = idx - r * D;
      if (r0 + r >= rep) continue;
      float acc = 0.0f;
      for (int s = 0; s < NS; ++s)
        acc += st_o[(s * DEC_RB + r) * D + d] * fac[s * DEC_RB + r];
      if (live == 1)
        o_out[(qrow0 + r0 + r) * D + d] = acc / fmaxf(tot[DEC_RB + r], 1e-30f);
      else
        ws[part + (size_t)(r0 + r) * D + d] = acc;
    }
    if (tid < DEC_RB && r0 + tid < rep) {
      if (live == 1) {
        m_out[qrow0 + r0 + tid] = tot[tid];
        l_out[qrow0 + r0 + tid] = tot[DEC_RB + tid];
      } else {
        float* ml = ws + part + (size_t)rep * D + 2 * (r0 + tid);
        ml[0] = tot[tid];
        ml[1] = tot[DEC_RB + tid];
      }
    }
    __syncthreads();                        // shared memory free again
  }
  if (live == 1) return;

  // the (slot, head)'s last CTA combines the live splits in split order
  if (!hf_last_of_group(tickets, grp, live)) return;
  const size_t first = (size_t)grp * nsp * rep * (D + 2);
  const size_t stride = (size_t)rep * (D + 2);      // one split's partial
  float* fac = reinterpret_cast<float*>(smem);      // [live][rep]
  float* tot = fac + live * rep;                    // M [rep], L [rep]
  for (int r = tid; r < rep; r += HF_THREADS) {
    const float* ml = ws + first + (size_t)rep * D + 2 * r;
    float M = HF_NEG_INF, Lsum = 0.0f;
    for (int i = 0; i < live; ++i) M = fmaxf(M, __ldcg(ml + i * stride));
    for (int i = 0; i < live; ++i) {
      const float f = expf(__ldcg(ml + i * stride) - M);
      fac[i * rep + r] = f;
      Lsum += __ldcg(ml + i * stride + 1) * f;
    }
    tot[r] = M;
    tot[rep + r] = Lsum;
  }
  __syncthreads();
  for (int idx = tid; idx < rep * D; idx += HF_THREADS) {
    const int r = idx / D;
    const float* po = ws + first + idx;
    float acc = 0.0f;
    for (int i = 0; i < live; ++i)
      acc += __ldcg(po + i * stride) * fac[i * rep + r];
    o_out[qrow0 * D + idx] = acc / fmaxf(tot[rep + r], 1e-30f);
  }
  for (int r = tid; r < rep; r += HF_THREADS) {
    m_out[qrow0 + r] = tot[r];
    l_out[qrow0 + r] = tot[rep + r];
  }
}

__device__ void decode_attn_member(const MemberDesc& md, int cta) {
  decode_split(md, cta);
}
