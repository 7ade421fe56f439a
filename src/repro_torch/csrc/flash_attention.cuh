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
//   fma (fp32): flash_f32_kernel below, fp32 FMAs on the CUDA cores, as the
//     reference multiplies fp32 in fp32 (no TF32), bound by the FMA rate
//     (67 TFLOP/s: 2.05 ms non-causal at granite's train shapes).
//
// Shared memory: amma_smem_bytes(128, D), 68 KB at D 128 (mma);
// ff_smem_bytes(D), 199 KB at D 128 and 187 KB at D 64 (fma); above the
// 48 KB default: the launchers opt in.
#pragma once

#include "attention_mma.cuh"

#define FLASH_MMA_ROWS 128  // mma route: rows a CTA

// The fp32 route, a register-tiled FFMA loop in the manner of an SGEMM.
//   * A CTA holds ff_rows(D) rows of one (batch, KV head), 256 at D <= 64
//     and 128 above, flattened as rr = position * rep + head of the group
//     (any rep, as the mma route), and walks kv tiles of FF_TK (64) keys;
//     CTAs of the heaviest causal row tiles, over all heads, launch first.
//   * 256 threads as row groups of 8 rows x G column groups (G = 8 at 256
//     rows, 16 at 128): thread (rg, cg) owns rows 8 rg .. 8 rg + 7 and, of
//     S = QK^T, keys cg + G u (u < 64 / G): 8 x 8 scores at D <= 64, 8 x 4
//     above; of O, columns 4 cg .. + 3 and 4 G + 4 cg .. + 3: 8 x 8
//     accumulators.  A 4-deep step of d reads 8 q float4s (rows) and 8 (4)
//     k float4s (keys) for 256 (128) FMAs; a 4-key step of P.V reads 8 p
//     float4s and 8 v float4s for 256 FMAs: at D <= 64, 4 FMAs per 32-bit
//     word read from shared memory in both products.  The G threads of a
//     row group are adjacent lanes: a q or p read is one address per group
//     (a broadcast), a k or v read a contiguous run of rows or columns.
//   * Shared rows are D + 4 floats (P's FF_TK + 4) apart, an odd number of
//     16-byte units, so the rows a quarter-warp reads lie in distinct bank
//     groups; the keys' interleave (cg + G u) keeps a warp's k rows
//     consecutive.
//   * Q is staged once; K and V tiles arrive through a ring of FF_SLOTS
//     slots by cp.async (16-byte copies), K_j, V_j, K_j+1, ... one slot a
//     phase, so while S_j is computed V_j and K_j+1 are in flight.
//   * Online softmax in registers: the scale multiplies the fp32 score, the
//     row max and sum are reduced across the row group by __shfl_xor_sync,
//     (m, l) kept per row, expf as the reference; P goes through shared
//     memory to the threads that own O's columns.
//   * Masking: only tiles that reach past S or past the CTA's first row's
//     causal limit are masked (-1e30, as the reference), so a row whose
//     keys of a tile are all masked adds exp(-1e30 - m) = 0 with alpha = 1;
//     l has the reference's 1e-30 floor.  A causal CTA stops at its last
//     row's position.
//   * One kernel for every head dim: the body is a template on the keys a
//     thread holds (ff_tile<8> at D <= 64, ff_tile<4> above), both inlined.
#define FF_TK 64
#define FF_SLOTS 3
#define FF_LDP (FF_TK + 4)

__host__ __device__ inline int ff_rows(int D) { return D <= 64 ? 256 : 128; }

__host__ __device__ inline int ff_smem_bytes(int D) {
  const int R = ff_rows(D);
  return 4 * ((FF_SLOTS * FF_TK + R) * (D + 4) + R * FF_LDP);
}

// one CTA's rows: KPT keys a thread of each 64-key tile, G = 64 / KPT
// threads a row group, RW = 8 * 256 / G rows
template <int KPT>
__device__ __forceinline__ void ff_tile(const float* q, const float* k,
                                        const float* v, float* o, int B,
                                        int S, int H, int Hkv, int D,
                                        int causal, float scale) {
  constexpr int G = FF_TK / KPT, RW = 8 * HF_THREADS / G;
  static_assert(HF_THREADS == 256 && (G == 8 || G == 16), "thread layout");
  extern __shared__ __align__(16) float ff_smem[];
  const int LD = D + 4;
  float* Qs = ff_smem;                        // [RW][LD]
  float* Ps = Qs + RW * LD;                   // [RW][FF_LDP]
  float* ring = Ps + RW * FF_LDP;             // FF_SLOTS x [FF_TK][LD]

  const int rep = H / Hkv, nrows = S * rep;
  const int ntile = (nrows + RW - 1) / RW;
  const int groups = B * Hkv;
  const int t = ntile - 1 - (int)(blockIdx.x / groups);   // heaviest first
  const int bg = blockIdx.x % groups, b = bg / Hkv, g = bg % Hkv;
  const int fr0 = t * RW;
  const int R = min(RW, nrows - fr0);
  const int n_kv = causal ? (fr0 + R - 1) / rep + 1 : S;
  const int ntk = (n_kv + FF_TK - 1) / FF_TK;
  const int lim0 = causal ? fr0 / rep + 1 : S;  // the first row's limit
  const size_t kv0 = ((size_t)b * S * Hkv + g) * D;
  const size_t kvs = (size_t)Hkv * D;           // elements between positions
  const int tid = threadIdx.x, cg = tid % G, rg = tid / G;
  const int cpr = D / 4;                        // 16-byte chunks a row

  // q row rr of the tile in global memory
  auto q_off = [&](int rr) {
    const int fr = fr0 + rr;
    return (((size_t)b * S + fr / rep) * H + g * rep + fr % rep) * D;
  };
  for (int c = tid; c < RW * cpr; c += HF_THREADS) {
    const int rr = c / cpr, d = (c - rr * cpr) * 4;
    const bool ok = rr < R;
    cp_async16(Qs + rr * LD + d, ok ? q + q_off(rr) + d : q, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // phase s of the kv loop reads slot s % FF_SLOTS: K tile s / 2 (s even)
  // or V tile s / 2 (s odd); positions past n_kv zero-filled
  auto load = [&](int s) {
    if (s < 2 * ntk) {
      float* dst = ring + (s % FF_SLOTS) * FF_TK * LD;
      const float* src = (s & 1 ? v : k) + kv0;
      const int p0 = (s >> 1) * FF_TK;
      for (int c = tid; c < FF_TK * cpr; c += HF_THREADS) {
        const int j = c / cpr, d = (c - j * cpr) * 4;
        const bool ok = p0 + j < n_kv;
        cp_async16(dst + j * LD + d, ok ? src + (size_t)(p0 + j) * kvs + d
                                        : src, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int s = 0; s < FF_SLOTS - 1; ++s) load(s);

  float acc[8][8], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = HF_NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }
  const bool lo = 4 * cg < D, hi = 4 * G + 4 * cg < D;  // O's columns

#pragma unroll 1
  for (int j = 0; j < ntk; ++j) {
    const int p0 = j * FF_TK;
    // S phase: slot 2j holds K_j
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FF_SLOTS - 2));
    __syncthreads();   // K_j landed; every read of P and of slot 2j-1 done
    load(2 * j + FF_SLOTS - 1);
    const float* Ks = ring + ((2 * j) % FF_SLOTS) * FF_TK * LD;
    float s[8][KPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < KPT; ++u) s[i][u] = 0.0f;
#pragma unroll 1
    for (int d = 0; d < D; d += 4) {
      float4 kf[KPT];
#pragma unroll
      for (int u = 0; u < KPT; ++u)
        kf[u] = *reinterpret_cast<const float4*>(Ks + (cg + G * u) * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(Qs + (8 * rg + i) * LD + d);
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          s[i][u] = fmaf(qf.x, kf[u].x, s[i][u]);
          s[i][u] = fmaf(qf.y, kf[u].y, s[i][u]);
          s[i][u] = fmaf(qf.z, kf[u].z, s[i][u]);
          s[i][u] = fmaf(qf.w, kf[u].w, s[i][u]);
        }
      }
    }
    // mask where the tile reaches past S or past the first row's limit
    const bool masked = p0 + FF_TK > min(n_kv, lim0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int fr = fr0 + 8 * rg + i;
      const int lim = causal ? fr / rep + 1 : S;
      float mx = HF_NEG_INF;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int key = p0 + cg + G * u;
        s[i][u] = masked && (key >= n_kv || key >= lim) ? HF_NEG_INF
                                                         : s[i][u] * scale;
        mx = fmaxf(mx, s[i][u]);
      }
#pragma unroll
      for (int x = 1; x < G; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        s[i][u] = expf(s[i][u] - m_new);
        sum += s[i][u];
        Ps[(8 * rg + i) * FF_LDP + cg + G * u] = s[i][u];
      }
#pragma unroll
      for (int x = 1; x < G; x <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }

    // P.V phase: slot 2j + 1 holds V_j
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FF_SLOTS - 2));
    __syncthreads();   // V_j landed, P written; slot 2j read
    load(2 * j + FF_SLOTS);
    const float* Vs = ring + ((2 * j + 1) % FF_SLOTS) * FF_TK * LD + 4 * cg;
    const int nk = min(FF_TK, n_kv - p0);
#pragma unroll 1
    for (int kk = 0; kk < nk; kk += 4) {
      float4 vf[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vs + (kk + u) * LD;
        vf[u][0] = lo ? *reinterpret_cast<const float4*>(vr)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        vf[u][1] = hi ? *reinterpret_cast<const float4*>(vr + 4 * G)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pf = *reinterpret_cast<const float4*>(
            Ps + (8 * rg + i) * FF_LDP + kk);
        const float pv[4] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pv[u], vf[u][0].x, acc[i][0]);
          acc[i][1] = fmaf(pv[u], vf[u][0].y, acc[i][1]);
          acc[i][2] = fmaf(pv[u], vf[u][0].z, acc[i][2]);
          acc[i][3] = fmaf(pv[u], vf[u][0].w, acc[i][3]);
          acc[i][4] = fmaf(pv[u], vf[u][1].x, acc[i][4]);
          acc[i][5] = fmaf(pv[u], vf[u][1].y, acc[i][5]);
          acc[i][6] = fmaf(pv[u], vf[u][1].z, acc[i][6]);
          acc[i][7] = fmaf(pv[u], vf[u][1].w, acc[i][7]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = 8 * rg + i;
    if (rr >= R) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* orow = o + q_off(rr) + 4 * cg;
    if (lo)
      *reinterpret_cast<float4*>(orow) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                      acc[i][3] * inv);
    if (hi)
      *reinterpret_cast<float4*>(orow + 4 * G) =
          make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv,
                      acc[i][7] * inv);
  }
}

__global__ void __launch_bounds__(HF_THREADS, 1)
    flash_f32_kernel(const float* q, const float* k, const float* v,
                     float* o, int B, int S, int H, int Hkv, int D,
                     int causal, float scale) {
  if (D <= 64)
    ff_tile<8>(q, k, v, o, B, S, H, Hkv, D, causal, scale);
  else
    ff_tile<4>(q, k, v, o, B, S, H, Hkv, D, causal, scale);
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
  const int smem = ff_smem_bytes(D);
  int e = hf_allow_kernel_smem(flash_f32_kernel, smem, &granted);
  if (e) return e;
  const long long rows = (long long)S * (H / Hkv);
  const long long grid =
      (long long)B * Hkv * ((rows + ff_rows(D) - 1) / ff_rows(D));
  flash_f32_kernel<<<(unsigned)grid, HF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, S, H, Hkv, D,
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
