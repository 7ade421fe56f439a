// Flash attention (train/prefill): q (B,S,H,D), k, v (B,S,Hkv,D) -> o
// (B,S,H,D), all of one type (bf16 or fp32), causal or not, GQA with query
// head h reading KV head h / (H / Hkv).  The reference's (BH,S,D) form is
// B = BH, H = Hkv = 1.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:54
// (flash_attention, body :21), as src/repro/kernels/ops.py:53 calls it.
// The reference repeats the KV heads to H and flattens (batch, head) before
// the call; here the kernel indexes KV head h / rep directly, which computes
// the same function without the copies.
//
// Bound on the card: operations.  At granite-3-2b's train shapes (B 4, S
// 2048, 32/8 heads, D 64) it does 68.7 GFLOP causal against 67 MB of q, k,
// v and o.  The reference carries (m, l, acc) across sequential kv grid
// steps in VMEM; CTAs run in no order, so here that carry is the kv loop of
// attn_loop (attention_core.cuh) inside one CTA: one CTA per (batch, KV
// head, tile of QT query positions) holds QT * rep query rows (32 at rep 4),
// so each staged k/v tile serves every query head of the group.  Scores,
// the running (m, l) and the output stay fp32, as in the reference; masked
// scores are -1e30 and l has a 1e-30 floor.  A causal CTA stops its kv loop
// at its last query position: a kv tile wholly past every row of the CTA
// would add exp(-1e30 - m) = 0 with alpha = 1 once position 0 has been seen,
// so skipping it is exact.  CTAs of the heaviest causal tiles launch first.
// The math runs on CUDA cores in fp32; tensor cores are later work.
//
// Shared memory: attn_smem_bytes(QT * rep, D, sizeof(T)), 107 KB at D 128
// fp32, above the 48 KB default: the launcher opts in.
#pragma once

#include "attention_core.cuh"

#define FLASH_ROWS 32       // query rows (positions x group heads) per CTA

__host__ __device__ inline int flash_q_tile(int rep) {
  return rep >= FLASH_ROWS ? 1 : FLASH_ROWS / rep;
}

template <typename T>
__global__ void __launch_bounds__(HF_THREADS)
    flash_attn_kernel(const T* q, const T* k, const T* v, T* o, int S, int H,
                      int Hkv, int D, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = H / Hkv;
  const int QT = flash_q_tile(rep);
  const int ntile = (S + QT - 1) / QT;
  const int bg = blockIdx.x / ntile;
  const int t = ntile - 1 - (int)(blockIdx.x % ntile);   // heaviest first
  const int b = bg / Hkv, g = bg % Hkv;
  const int c0 = t * QT, nq = min(QT, S - c0);
  const int R = nq * rep;                   // row rr = cq * rep + r

  AttnSmemT<T> sm = attn_smem<T>(smem, QT * rep, D);
  for (int idx = threadIdx.x; idx < R * D; idx += HF_THREADS) {
    const int rr = idx / D, d = idx % D;
    const int cq = rr / rep, r = rr % rep;
    sm.q[idx] =
        to_f32(q[(((size_t)b * S + c0 + cq) * H + g * rep + r) * D + d]) *
        scale;
    sm.o[idx] = 0.0f;
  }
  for (int rr = threadIdx.x; rr < R; rr += HF_THREADS) {
    sm.m[rr] = HF_NEG_INF;
    sm.l[rr] = 0.0f;
    sm.lim[rr] = causal ? c0 + rr / rep + 1 : S;   // kpos <= qpos
  }
  __syncthreads();

  const int n_kv = causal ? min(S, c0 + nq) : S;
  const size_t base = ((size_t)b * S * Hkv + g) * D;
  attn_loop(sm, R, D, n_kv, k + base, v + base, Hkv * D, nullptr, 0);

  for (int idx = threadIdx.x; idx < R * D; idx += HF_THREADS) {
    const int rr = idx / D, d = idx % D;
    const int cq = rr / rep, r = rr % rep;
    o[(((size_t)b * S + c0 + cq) * H + g * rep + r) * D + d] =
        from_f32<T>(sm.o[idx] / fmaxf(sm.l[rr], 1e-30f));
  }
}

template <typename T>
static int flash_launch(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int Hkv, int D, int causal,
                        float scale, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int rep = H / Hkv, QT = flash_q_tile(rep);
  const int smem = attn_smem_bytes(QT * rep, D, (int)sizeof(T));
  int e = hf_allow_kernel_smem(flash_attn_kernel<T>, smem, &granted);
  if (e) return e;
  const long long grid = (long long)B * Hkv * ((S + QT - 1) / QT);
  flash_attn_kernel<T><<<(unsigned)grid, HF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, D, causal,
      scale);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int hf_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int Hkv, int D, int fp32,
                       int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32 ? flash_launch<float>(q, k, v, o, B, S, H, Hkv, D, causal,
                                    scale, s)
              : flash_launch<bf16>(q, k, v, o, B, S, H, Hkv, D, causal, scale,
                                   s);
}

}  // extern "C"
