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
// steps in VMEM; CTAs run in no order, so here that carry is a kv loop
// inside one CTA.  A CTA holds a tile of one (batch, KV head)'s rows in the
// order rr = position * rep + head of the group, so each staged k/v tile
// serves every query head of the group.  A causal CTA stops its kv loop at
// its last row's position: a kv tile wholly past every row of the CTA would
// add exp(-1e30 - m) = 0 with alpha = 1 once position 0 has been seen, so
// skipping it is exact.  Masked scores are -1e30 and l has a 1e-30 floor.
// Two routes, picked by the dtype:
//   mma (bf16): attn_mma (attention_mma.cuh), QK^T and P.V on the tensor
//     cores, 128 rows a CTA (8 warps x 16), so granite's train shapes give
//     2048 CTAs; CTAs of the heaviest causal row tiles, over all heads,
//     launch first.  At most 128 registers a thread (two CTAs per SM).
//   fma (fp32): attn_loop (attention_core.cuh), fp32 FMAs on the CUDA
//     cores, as the reference multiplies fp32 in fp32; 32 rows a CTA, the
//     heaviest tiles of each (batch, KV head) first.
//
// Shared memory: amma_smem_bytes(128, D), 68 KB at D 128 (mma);
// attn_smem_bytes(32, D, 4), 107 KB at D 128 (fma); above the 48 KB
// default: the launchers opt in.
#pragma once

#include "attention_core.cuh"
#include "attention_mma.cuh"

#define FLASH_ROWS 32       // fma route: rows (positions x group heads) a CTA
#define FLASH_MMA_ROWS 128  // mma route: rows a CTA

__host__ __device__ inline int flash_q_tile(int rep) {
  return rep >= FLASH_ROWS ? 1 : FLASH_ROWS / rep;
}

__global__ void __launch_bounds__(HF_THREADS)
    flash_f32_kernel(const float* q, const float* k, const float* v,
                     float* o, int S, int H, int Hkv, int D, int causal,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = H / Hkv;
  const int QT = flash_q_tile(rep);
  const int ntile = (S + QT - 1) / QT;
  const int bg = blockIdx.x / ntile;
  const int t = ntile - 1 - (int)(blockIdx.x % ntile);   // heaviest first
  const int b = bg / Hkv, g = bg % Hkv;
  const int c0 = t * QT, nq = min(QT, S - c0);
  const int R = nq * rep;                   // row rr = cq * rep + r

  AttnSmemT<float> sm = attn_smem<float>(smem, QT * rep, D);
  for (int idx = threadIdx.x; idx < R * D; idx += HF_THREADS) {
    const int rr = idx / D, d = idx % D;
    const int cq = rr / rep, r = rr % rep;
    sm.q[idx] = q[(((size_t)b * S + c0 + cq) * H + g * rep + r) * D + d] *
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
        sm.o[idx] / fmaxf(sm.l[rr], 1e-30f);
  }
}

// the rows of one (batch, KV head) from flattened row fr0 (attn_mma's Rows)
struct FlashRows {
  const bf16* q;
  bf16* o;
  size_t base;          // row of (position 0, head g * rep)
  int H, rep, D, S, causal, fr0;
  __device__ size_t row(int i) const {
    const int fr = fr0 + i;
    return base + (size_t)(fr / rep) * H + fr % rep;
  }
  __device__ const bf16* q_row(int i) const { return q + row(i) * D; }
  __device__ int lim(int i) const { return causal ? (fr0 + i) / rep + 1 : S; }
  __device__ void store(size_t r, int d, float x, float y) const {
    *reinterpret_cast<__nv_bfloat162*>(o + r * D + d) =
        __floats2bfloat162_rn(x, y);
  }
  __device__ void store_ml(size_t, float, float) const {}
};

template <int DMAX>
__global__ void __launch_bounds__(HF_THREADS, 2)
    flash_mma_kernel(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                     int B, int S, int H, int Hkv, int D, int causal,
                     float scale) {
  const int rep = H / Hkv, nrows = S * rep;
  const int ntile = (nrows + FLASH_MMA_ROWS - 1) / FLASH_MMA_ROWS;
  const int groups = B * Hkv;
  const int t = ntile - 1 - (int)(blockIdx.x / groups);   // heaviest first
  const int bg = blockIdx.x % groups, b = bg / Hkv, g = bg % Hkv;
  const int fr0 = t * FLASH_MMA_ROWS;
  const int R = min(FLASH_MMA_ROWS, nrows - fr0);
  const FlashRows rows{q, o, (size_t)b * S * H + (size_t)g * rep, H, rep, D,
                       S, causal, fr0};
  const int n_kv = causal ? (fr0 + R - 1) / rep + 1 : S;
  const size_t kv0 = ((size_t)b * S * Hkv + g) * D;
  attn_mma<DMAX, amma_tkw(DMAX)>(rows, R, FLASH_MMA_ROWS, D, n_kv, k + kv0,
                                 v + kv0, Hkv * D, nullptr, 0, scale);
}

static int flash_f32_launch(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, int Hkv, int D,
                            int causal, float scale, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int rep = H / Hkv, QT = flash_q_tile(rep);
  const int smem = attn_smem_bytes(QT * rep, D, 4);
  int e = hf_allow_kernel_smem(flash_f32_kernel, smem, &granted);
  if (e) return e;
  const long long grid = (long long)B * Hkv * ((S + QT - 1) / QT);
  flash_f32_kernel<<<(unsigned)grid, HF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, D,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
static int flash_mma_launch(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, int Hkv, int D,
                            int causal, float scale, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int smem = amma_smem_bytes(FLASH_MMA_ROWS, D);
  int e = hf_allow_kernel_smem(flash_mma_kernel<DMAX>, smem, &granted);
  if (e) return e;
  const long long rows = (long long)S * (H / Hkv);
  const long long grid =
      (long long)B * Hkv * ((rows + FLASH_MMA_ROWS - 1) / FLASH_MMA_ROWS);
  flash_mma_kernel<DMAX><<<(unsigned)grid, HF_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), B, S, H, Hkv, D,
      causal, scale);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch on `stream`: fp32 on the fma route, bf16 on the mma route; a head
// dim outside 8..128 in steps of 8 is refused.  Returns the cudaError_t of
// the launch (0 = queued).
int hf_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int Hkv, int D, int fp32,
                       int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 || D < 8 || D > 128) return (int)cudaErrorInvalidValue;
  if (fp32)
    return flash_f32_launch(q, k, v, o, B, S, H, Hkv, D, causal, scale, s);
  return D <= 64 ? flash_mma_launch<64>(q, k, v, o, B, S, H, Hkv, D, causal,
                                        scale, s)
                 : flash_mma_launch<128>(q, k, v, o, B, S, H, Hkv, D, causal,
                                         scale, s);
}

}  // extern "C"
