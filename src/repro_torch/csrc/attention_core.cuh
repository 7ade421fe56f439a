// Online-softmax attention of R query rows (one KV head) against one
// sequence's cache on the CUDA cores: the fp32 route of the standalone flash
// attention kernel.  bf16 flash attention and the prefill attention member
// run on the tensor cores (attention_mma.cuh); decode attention has a
// split-KV loop of its own (decode_attention.cuh).
//
// The TPU kernel carries m, l and o across sequential grid steps in outputs
// with constant index maps (src/repro/kernels/flash_attention.py:21-50).
// CTAs run in no order, so here that carry is a loop inside the CTA: kv
// tiles of ATT_TK positions are staged in shared memory, scores and the
// running (m, l, o) stay fp32 in shared memory, and nothing crosses CTAs.
// Masked scores are -1e30 and l has a 1e-30 floor, as in the reference, so
// even a row with every position masked gives the reference's answer.
//
// Bound: fp32 flash does its fp32 FMAs on the CUDA cores, as the reference
// multiplies fp32 in fp32 (operations-bound, two shared-memory operands per
// FMA).
#pragma once

#include "common.cuh"

#define ATT_TK 64           // kv positions per shared-memory tile

// k rows in shared memory are an odd number of 32-bit words apart
// (conflict-free row reads): D + 2 bf16 or D + 1 fp32 elements.
__host__ __device__ inline int attn_kstride(int D, int esize) {
  return D + 4 / esize;
}

// shared-memory layout for R rows of head dim D and k/v elements of `esize`
// bytes (all offsets 16-aligned):
//   q_s, o_s [R*D] f32 | s_s [R*TK] f32 | m_s, l_s, a_s [R] f32 | lim_s [R] int
//   | k_s [TK*kstride] | v_s [TK*D]
__host__ __device__ inline int attn_smem_bytes(int R, int D, int esize = 2) {
  return hf_align16(4 * (2 * R * D + R * ATT_TK + 4 * R)) +
         hf_align16(esize * ATT_TK * attn_kstride(D, esize)) +
         esize * ATT_TK * D;
}

template <typename T>
struct AttnSmemT {
  float *q, *o, *s, *m, *l, *a;
  int* lim;
  T *k, *v;
};
typedef AttnSmemT<bf16> AttnSmem;

template <typename T = bf16>
__device__ __forceinline__ AttnSmemT<T> attn_smem(unsigned char* base, int R,
                                                  int D) {
  constexpr int es = (int)sizeof(T);
  AttnSmemT<T> p;
  float* f = reinterpret_cast<float*>(base);
  p.q = f;
  p.o = p.q + R * D;
  p.s = p.o + R * D;
  p.m = p.s + R * ATT_TK;
  p.l = p.m + R;
  p.a = p.l + R;
  p.lim = reinterpret_cast<int*>(p.a + R);
  unsigned char* b = base + hf_align16(4 * (2 * R * D + R * ATT_TK + 4 * R));
  p.k = reinterpret_cast<T*>(b);
  p.v = reinterpret_cast<T*>(b +
                             hf_align16(es * ATT_TK * attn_kstride(D, es)));
  return p;
}

// two neighbouring elements of a staged k row, as fp32
__device__ __forceinline__ float2 attn_pair(const bf16* row, int d2) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[d2]);
}
__device__ __forceinline__ float2 attn_pair(const float* row, int d2) {
  return make_float2(row[2 * d2], row[2 * d2 + 1]);
}

// Visit kv positions [0, n_kv).  Row r admits position p iff p < lim[r].
// kbase/vbase point at cache row 0 of this head; rows are kv_stride elements
// apart.  Contiguous cache (bt null): position p is row p.  Paged cache: the
// arena's rows are its blocks' rows back to back, and position p is row
// bt[p / bs] * bs + p % bs, the page-table lookup of the reference's
// gather_pages (src/repro/kernels/decode_attention.py:35), one per staged kv
// row; a 64-position tile spans 64 / bs pages.  Only the load address
// differs, so on equal logical content both forms compute bitwise the same.
// On entry q holds the scaled queries, m = -1e30, l = 0, o = 0; on exit o
// holds the unnormalised sum.
template <typename T>
__device__ void attn_loop(const AttnSmemT<T>& sm, int R, int D, int n_kv,
                          const T* kbase, const T* vbase, int kv_stride,
                          const int* bt, int bs) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte vector
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KS = attn_kstride(D, (int)sizeof(T));
  const int vpr = D / VEC;                  // 16-byte vectors per row
  for (int p0 = 0; p0 < n_kv; p0 += ATT_TK) {
    const int nt = min(ATT_TK, n_kv - p0);
    for (int idx = tid; idx < ATT_TK * vpr; idx += HF_THREADS) {
      const int j = idx / vpr, c = (idx % vpr) * VEC;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (j < nt) {
        const int p = p0 + j;
        const int row = bt ? bt[p / bs] * bs + p % bs : p;
        const size_t g = (size_t)row * kv_stride + c;
        kv4 = *reinterpret_cast<const uint4*>(kbase + g);
        vv4 = *reinterpret_cast<const uint4*>(vbase + g);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(sm.k + j * KS + c);
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      *reinterpret_cast<uint4*>(sm.v + j * D + c) = vv4;
    }
    __syncthreads();

    for (int idx = tid; idx < R * ATT_TK; idx += HF_THREADS) {
      const int r = idx / ATT_TK, j = idx % ATT_TK;
      float s = HF_NEG_INF;
      if (j < nt && p0 + j < sm.lim[r]) {
        const float* qr = sm.q + r * D;
        const T* kr = sm.k + j * KS;
        float acc = 0.0f;
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 kk = attn_pair(kr, d2);
          acc = fmaf(qr[2 * d2], kk.x, acc);
          acc = fmaf(qr[2 * d2 + 1], kk.y, acc);
        }
        s = acc;
      }
      sm.s[idx] = s;
    }
    __syncthreads();

    for (int r = warp; r < R; r += HF_WARPS) {
      float* sr = sm.s + r * ATT_TK;
      float mx = HF_NEG_INF;
      for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < ATT_TK; j += 32) {
        const float p = j < nt ? expf(sr[j] - m_new) : 0.0f;
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sm.a[r] = alpha;
        sm.l[r] = sm.l[r] * alpha + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * D; idx += HF_THREADS) {
      const int r = idx / D, d = idx % D;
      const float* pr = sm.s + r * ATT_TK;
      float acc = 0.0f;
      for (int j = 0; j < nt; ++j)
        acc = fmaf(pr[j], to_f32(sm.v[j * D + d]), acc);
      sm.o[idx] = sm.o[idx] * sm.a[r] + acc;
    }
    __syncthreads();
  }
}
