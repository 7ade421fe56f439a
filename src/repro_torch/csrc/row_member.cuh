// Row member family: RMSNorm, the row GEMM with an optional RMSNorm prologue
// and an optional activation or residual-add epilogue, the activation alone
// and the residual add alone.
//
// Replaces the TPU kernels src/repro/kernels/rmsnorm.py:38 (rmsnorm_op) and
// :20 (rmsnorm, the same body launched alone), src/repro/kernels/matmul.py:64
// (matmul_1d_op), src/repro/kernels/elementwise.py:20 (activation_op) and :69
// (residual_add_op), and the chain body of src/repro/core/stitch.py:177
// (stitch) for three pairs: rmsnorm->matmul (decode_norm1->qkv_proj),
// matmul->activation (ffn_proj->decode_act) and matmul->residual_add.
//
// Bound on the card: bytes.  At decode batch (M = 8 rows) the GEMM does 2*M
// flops per weight element it streams, far under the H100's ~295 flop/byte
// ridge, so its time is the weight stream (12.6 MB for granite's QKV weight,
// 67 MB for its gate+up weight).  Design: a CTA owns a 64-column tile of the
// weight for all M rows; each thread streams 16-byte vectors (8 columns of one
// weight row), x sits in shared memory, sums stay fp32.  The chains keep the
// intermediate out of device memory: the prologue normalises x straight into
// shared memory, the epilogue activates the fp32 tile before the only store.
// A gated epilogue needs gate column j and up column j+F in one CTA, so the
// gated tile is 32 gate columns plus their 32 up columns.
//
// RMSNorm and the residual add take bf16 or, with i[6] = 1, fp32 rows (the
// reference's tests run the standalone norm in fp32).  Both are bound by
// bytes.  The residual add streams its (M, F) operands in 16-byte vectors,
// 16 KB of each operand per CTA, every load of a thread issued before its
// first add.
//
// fp32 GEMM (i[6] = 1, the MoE router: 8 x 4096 @ 4096 x 16 at phi3.5-moe):
// x, w and out fp32, no prologue or activation.  A CTA owns 64 columns and one
// of i[7] slices of K (the router's N = 16 is a quarter of one tile, so a
// single CTA walking all of K is bound by load latency: 0.19 ms on the H100).
// A thread streams 16-byte vectors of 4 columns, reads x through the cache (a
// half-warp shares one x value), and columns past N are masked, so N needs
// only N % 4 == 0.  Each CTA writes its slice's (M, 64) partial into a
// per-launch workspace (out[1]) and takes a ticket of its column tile
// (out[2], zeroed); the tile's last CTA sums the slices in slice order, as
// the paper members' carries do, so the result is the same every launch.
// With the residual epilogue (i[8] = 1, in[3] = res (M, N)) that CTA adds
// res to each column's sum before the store.
//
// Bitwise contract: a chain equals its two members run separately.  The
// prologue rounds the normed row to bf16 exactly as the standalone norm
// stores it; the activation epilogue rounds the product to bf16 exactly as
// the standalone GEMM stores it; the residual epilogue does the same (fp32:
// the product is the stored value), adds res in fp32 and rounds, as the
// standalone residual add does; each column's K-sum runs in the same order
// whichever tile holds it; the build uses -fmad=false so no call site fuses
// a multiply-add the other does not.
#pragma once

#include "common.cuh"

enum { ROW_NORM = 0, ROW_GEMM = 1, ROW_ACT = 2, ROW_RESADD = 3 };
enum { ACT_NONE = -1, ACT_SILU_GATE = 0, ACT_GELU_GATE = 1, ACT_GELU = 2,
       ACT_RELU2 = 3 };

#define GEMM_TN 64          // weight columns per CTA tile
#define GEMM_MB 8           // rows per pass (accumulators: GEMM_MB x 8 / thread)
#define ACT_COLS 2048       // output columns per CTA of the standalone activation
#define RESADD_VECS 4       // 16-byte vectors per thread per operand of the
                            // standalone residual add (all loads in flight
                            // before the first add)

__host__ __device__ __forceinline__ bool act_gated(int act) {
  return act == ACT_SILU_GATE || act == ACT_GELU_GATE;
}

// tanh-approximate GELU (jax.nn.gelu's default), fp32
__device__ __forceinline__ float gelu_tanh(float a) {
  float a3 = a * a * a;
  float inner = 0.7978845608028654f * (a + 0.044715f * a3);
  return 0.5f * a * (1.0f + tanhf(inner));
}

// act(a) * b for the gated forms, act(a) for the plain ones; fp32 inputs
__device__ __forceinline__ float act_apply(int act, float a, float b) {
  switch (act) {
    case ACT_SILU_GATE: return (a * (1.0f / (1.0f + expf(-a)))) * b;
    case ACT_GELU_GATE: return gelu_tanh(a) * b;
    case ACT_GELU: return gelu_tanh(a);
    default: {  // ACT_RELU2
      float r = fmaxf(a, 0.0f);
      return r * r;
    }
  }
}

// y = x * rsqrt(mean(x^2) + eps) * (1 + scale), fp32 math, stored as T
// (bf16 or fp32).  All HF_THREADS threads of the CTA call it; red holds
// HF_WARPS floats.
template <typename T>
__device__ void rms_row(const T* x, const float* scale, int d, float eps,
                        T* y, float* red) {
  float ss = 0.0f;
  for (int k = threadIdx.x; k < d; k += HF_THREADS) {
    float v = to_f32(x[k]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.0f;
#pragma unroll
  for (int w = 0; w < HF_WARPS; ++w) tot += red[w];
  float inv = rsqrtf(tot / (float)d + eps);
  for (int k = threadIdx.x; k < d; k += HF_THREADS)
    y[k] = from_f32<T>(to_f32(x[k]) * inv * (1.0f + scale[k]));
  __syncthreads();
}

__host__ __device__ inline int gemm_smem_bytes(int K) {
  return hf_align16(GEMM_MB * K * 2) + HF_WARPS * GEMM_MB * GEMM_TN * 4 +
         GEMM_MB * GEMM_TN * 4 + HF_WARPS * 4;
}

__device__ __forceinline__ void gemm_fma(float (&acc)[GEMM_MB][8],
                                         const bf16* xs, int K, int k, int mb,
                                         uint4 wv) {
  float wf[8];
  unpack8(wv, wf);
#pragma unroll
  for (int r = 0; r < GEMM_MB; ++r) {
    if (r < mb) {
      float xv = bf2f(xs[r * K + k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
    }
  }
}

// out(M, N or F) = epilogue(prologue(x)(M, K) @ w(K, N))
__device__ void row_gemm(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = m.i[1], K = m.i[2], N = m.i[3];
  const int prologue = m.i[4], act = m.i[5];
  const float eps = m.f[0];
  const bf16* x = static_cast<const bf16*>(m.in[0]);
  const float* scale = static_cast<const float*>(m.in[1]);
  const bf16* w = static_cast<const bf16*>(m.in[2]);
  bf16* out = static_cast<bf16*>(m.out[0]);
  const bool gated = act_gated(act);
  const int F = N / 2;

  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + hf_align16(GEMM_MB * K * 2));
  float* tile = red + HF_WARPS * GEMM_MB * GEMM_TN;
  float* nred = tile + GEMM_MB * GEMM_TN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & 7;       // this thread's 8-column group in the tile
  const int kr = tid >> 3;      // this thread's k residue mod 32
  int col0;
  if (gated)
    col0 = (cg < 4) ? cta * (GEMM_TN / 2) + cg * 8
                    : F + cta * (GEMM_TN / 2) + (cg - 4) * 8;
  else
    col0 = cta * GEMM_TN + cg * 8;

  for (int m0 = 0; m0 < M; m0 += GEMM_MB) {
    const int mb = min(GEMM_MB, M - m0);
    if (prologue) {
      for (int r = 0; r < mb; ++r)
        rms_row(x + (size_t)(m0 + r) * K, scale, K, eps, xs + r * K, nred);
    } else {
      const int nv = mb * K / 8;
      for (int v = tid; v < nv; v += HF_THREADS)
        reinterpret_cast<uint4*>(xs)[v] =
            reinterpret_cast<const uint4*>(x + (size_t)m0 * K)[v];
    }
    __syncthreads();

    float acc[GEMM_MB][8];
#pragma unroll
    for (int r = 0; r < GEMM_MB; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;

    // four weight vectors in flight per thread; k ascends in both loops,
    // so every column's sum runs in one fixed order
    int k = kr;
    for (; k + 96 < K; k += 128) {
      uint4 w0 = *reinterpret_cast<const uint4*>(w + (size_t)k * N + col0);
      uint4 w1 = *reinterpret_cast<const uint4*>(w + (size_t)(k + 32) * N + col0);
      uint4 w2 = *reinterpret_cast<const uint4*>(w + (size_t)(k + 64) * N + col0);
      uint4 w3 = *reinterpret_cast<const uint4*>(w + (size_t)(k + 96) * N + col0);
      gemm_fma(acc, xs, K, k, mb, w0);
      gemm_fma(acc, xs, K, k + 32, mb, w1);
      gemm_fma(acc, xs, K, k + 64, mb, w2);
      gemm_fma(acc, xs, K, k + 96, mb, w3);
    }
    for (; k < K; k += 32) {
      uint4 w0 = *reinterpret_cast<const uint4*>(w + (size_t)k * N + col0);
      gemm_fma(acc, xs, K, k, mb, w0);
    }

    // lanes l, l^8, l^16, l^24 share a column group: fold them, then the
    // eight warps through shared memory in warp order
#pragma unroll
    for (int r = 0; r < GEMM_MB; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = acc[r][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) red[(warp * GEMM_MB + r) * GEMM_TN + cg * 8 + j] = v;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < mb * GEMM_TN; idx += HF_THREADS) {
      const int r = idx / GEMM_TN, c = idx % GEMM_TN;
      float s = 0.0f;
#pragma unroll
      for (int wv = 0; wv < HF_WARPS; ++wv)
        s += red[(wv * GEMM_MB + r) * GEMM_TN + c];
      tile[idx] = s;
    }
    __syncthreads();

    if (gated) {
      for (int idx = tid; idx < mb * (GEMM_TN / 2); idx += HF_THREADS) {
        const int r = idx / (GEMM_TN / 2), c = idx % (GEMM_TN / 2);
        const float a = bf_round(tile[r * GEMM_TN + c]);
        const float b = bf_round(tile[r * GEMM_TN + GEMM_TN / 2 + c]);
        out[(size_t)(m0 + r) * F + cta * (GEMM_TN / 2) + c] =
            f2bf(act_apply(act, a, b));
      }
    } else {
      // read here, not live across the K loop
      const bf16* res = m.i[8] ? static_cast<const bf16*>(m.in[3]) : nullptr;
      for (int idx = tid; idx < mb * GEMM_TN; idx += HF_THREADS) {
        const int r = idx / GEMM_TN, c = idx % GEMM_TN;
        const size_t o = (size_t)(m0 + r) * N + cta * GEMM_TN + c;
        const float h = tile[idx];
        out[o] = f2bf(res ? bf_round(h) + bf2f(res[o])
                      : act == ACT_NONE ? h
                                        : act_apply(act, bf_round(h), 0.0f));
      }
    }
    __syncthreads();
  }
}

// fp32 GEMM: out(M, N) = x(M, K) @ w(K, N), every operand fp32, split over
// i[7] slices of K
#define GEMM_F32_KR 16      // k residues (threads per column group)

__host__ __device__ inline int gemm_f32_smem_bytes() {
  return HF_WARPS * GEMM_MB * GEMM_TN * 4;
}

// Not inlined: inlined, its split-K bookkeeping made ptxas spill inside the
// 128-register bundle kernel; as a call it spills nothing itself and the
// other members keep their allocation.
__device__ __noinline__ void row_gemm_f32(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = m.i[1], K = m.i[2], N = m.i[3], KS = m.i[7];
  const float* x = static_cast<const float*>(m.in[0]);
  const float* w = static_cast<const float*>(m.in[2]);
  const float* res = m.i[8] ? static_cast<const float*>(m.in[3]) : nullptr;
  float* out = static_cast<float*>(m.out[0]);
  float* ws = static_cast<float*>(m.out[1]);
  float* red = reinterpret_cast<float*>(smem);

  const int ntile = (N + GEMM_TN - 1) / GEMM_TN;
  const int tile = cta % ntile, ks = cta / ntile;
  const int kchunk = (K + KS - 1) / KS;
  const int k0 = ks * kchunk, k1 = min(K, k0 + kchunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % (GEMM_TN / 4);     // this thread's 4-column group
  const int kr = tid / (GEMM_TN / 4);     // this thread's k residue
  const int col0 = tile * GEMM_TN + cg * 4;
  const bool live = col0 < N;

  for (int m0 = 0; m0 < M; m0 += GEMM_MB) {
    const int mb = min(GEMM_MB, M - m0);
    float acc[GEMM_MB][4];
#pragma unroll
    for (int r = 0; r < GEMM_MB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
    if (live) {
      // k ascends: every column's sum runs in one fixed order
#pragma unroll 2
      for (int k = k0 + kr; k < k1; k += GEMM_F32_KR) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w + (size_t)k * N + col0);
#pragma unroll
        for (int r = 0; r < GEMM_MB; ++r) {
          if (r < mb) {
            const float xv = x[(size_t)(m0 + r) * K + k];
            acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
            acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
            acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
            acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
          }
        }
      }
    }
    // lanes l and l^16 share a column group: fold them, then the eight
    // warps through shared memory in warp order, into this slice's partial
#pragma unroll
    for (int r = 0; r < GEMM_MB; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = acc[r][j] + __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
        if (lane < 16) red[(warp * GEMM_MB + r) * GEMM_TN + cg * 4 + j] = v;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < mb * GEMM_TN; idx += HF_THREADS) {
      const int r = idx / GEMM_TN, c = idx % GEMM_TN;
      const int col = tile * GEMM_TN + c;
      if (col < N) {
        float s = 0.0f;
#pragma unroll
        for (int wv = 0; wv < HF_WARPS; ++wv)
          s += red[(wv * GEMM_MB + r) * GEMM_TN + c];
        ws[((size_t)ks * M + m0 + r) * N + col] = s;
      }
    }
    __syncthreads();
  }

  // the tile's last CTA sums the K slices in slice order
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), tile, KS)) return;
  for (int idx = tid; idx < M * GEMM_TN; idx += HF_THREADS) {
    const int r = idx / GEMM_TN, col = tile * GEMM_TN + idx % GEMM_TN;
    if (col < N) {
      float s = ws[(size_t)r * N + col];
      for (int q = 1; q < KS; ++q) s += ws[((size_t)q * M + r) * N + col];
      if (res) s += res[(size_t)r * N + col];
      out[(size_t)r * N + col] = s;
    }
  }
}

// standalone activation: h (M, F_in) bf16 -> out (M, F_out) bf16
__device__ void row_act(const MemberDesc& m, int cta) {
  const int M = m.i[1], F_in = m.i[2], F_out = m.i[3], act = m.i[5];
  const bf16* h = static_cast<const bf16*>(m.in[0]);
  bf16* out = static_cast<bf16*>(m.out[0]);
  const int nchunk = (F_out + ACT_COLS - 1) / ACT_COLS;
  const int r = cta / nchunk, c0 = (cta % nchunk) * ACT_COLS;
  if (r >= M) return;
  const bool gated = act_gated(act);
  for (int j = c0 + threadIdx.x; j < min(F_out, c0 + ACT_COLS);
       j += HF_THREADS) {
    const float a = bf2f(h[(size_t)r * F_in + j]);
    const float b = gated ? bf2f(h[(size_t)r * F_in + F_out + j]) : 0.0f;
    out[(size_t)r * F_out + j] = f2bf(act_apply(act, a, b));
  }
}

// one 16-byte vector of T (8 bf16 or 4 fp32) <-> fp32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) f[j] = to_f32(e[j]);
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) e[j] = from_f32<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

// standalone residual add: out = h + res over (M, F), in fp32, stored as T;
// CTA c owns elements [c * CH, (c + 1) * CH), CH = HF_THREADS * RESADD_VECS
// 16-byte vectors.  Not inlined, like row_norm_f32 below: inlined, these
// two paths moved ptxas's allocation of the whole bundle kernel and slowed
// the grouped expert FFN member by 5% on the H100; as calls the kernel keeps
// the allocation (and the 24 bytes of spills) it had without them.
template <typename T>
__device__ __noinline__ void row_resadd(const MemberDesc& m, int cta) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = HF_THREADS * RESADD_VECS * VEC;
  const long long n = (long long)m.i[1] * m.i[2];
  const long long e0 = (long long)cta * CH;
  const long long e1 = min(n, e0 + CH);
  const T* h = static_cast<const T*>(m.in[0]);
  const T* r = static_cast<const T*>(m.in[1]);
  T* out = static_cast<T*>(m.out[0]);
  const long long ev = e0 + (e1 - e0) / VEC * VEC;   // end of whole vectors
  uint4 hv[RESADD_VECS], rv[RESADD_VECS];
#pragma unroll
  for (int i = 0; i < RESADD_VECS; ++i) {
    const long long e = e0 + ((long long)i * HF_THREADS + threadIdx.x) * VEC;
    if (e < ev) {
      hv[i] = *reinterpret_cast<const uint4*>(h + e);
      rv[i] = *reinterpret_cast<const uint4*>(r + e);
    }
  }
#pragma unroll
  for (int i = 0; i < RESADD_VECS; ++i) {
    const long long e = e0 + ((long long)i * HF_THREADS + threadIdx.x) * VEC;
    if (e < ev) {
      float a[VEC], b[VEC];
      unpack16<T>(hv[i], a);
      unpack16<T>(rv[i], b);
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] += b[j];
      store16(out + e, a);
    }
  }
  for (long long e = ev + threadIdx.x; e < e1; e += HF_THREADS)
    out[e] = from_f32<T>(to_f32(h[e]) + to_f32(r[e]));
}

template <typename T>
__device__ void row_norm(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = m.i[2];
  rms_row(static_cast<const T*>(m.in[0]) + (size_t)cta * d,
          static_cast<const float*>(m.in[1]), d, m.f[0],
          static_cast<T*>(m.out[0]) + (size_t)cta * d,
          reinterpret_cast<float*>(smem));
}

__device__ __noinline__ void row_norm_f32(const MemberDesc& m, int cta) {
  row_norm<float>(m, cta);
}

__device__ void row_member(const MemberDesc& m, int cta) {
  switch (m.i[0]) {
    case ROW_NORM:
      if (m.i[6])
        row_norm_f32(m, cta);
      else
        row_norm<bf16>(m, cta);
      break;
    case ROW_GEMM:
      if (m.i[6])
        row_gemm_f32(m, cta);
      else
        row_gemm(m, cta);
      break;
    case ROW_RESADD:
      if (m.i[6])
        row_resadd<float>(m, cta);
      else
        row_resadd<bf16>(m, cta);
      break;
    default: row_act(m, cta); break;
  }
}

__host__ __device__ inline int row_smem_bytes(const MemberDesc& m) {
  switch (m.i[0]) {
    case ROW_NORM: return HF_WARPS * 4;
    case ROW_GEMM: return m.i[6] ? gemm_f32_smem_bytes()
                                 : gemm_smem_bytes(m.i[2]);
    default: return 0;   // activation, residual add
  }
}
