// Row member family: RMSNorm, the row GEMM, the activation and the residual
// add, each alone, and every chain of two of them (or of one of them and the
// AdamW update) that src/repro/core/stitch.py:177 (stitch) builds.
//
// Replaces the TPU kernels src/repro/kernels/rmsnorm.py:38 (rmsnorm_op) and
// :20 (rmsnorm, the same body launched alone), src/repro/kernels/matmul.py:64
// (matmul_1d_op), src/repro/kernels/elementwise.py:20 (activation_op) and :69
// (residual_add_op), and the chain body of src/repro/core/stitch.py:177
// (stitch, :198-210) for every producer -> consumer pair of them, the
// dW GEMM -> AdamW update (src/repro/kernels/adam.py:67) included.
//
// Bound on the card: bytes.  At decode batch (M = 8 rows) the GEMM does 2*M
// flops per weight element it streams, far under the H100's ~295 flop/byte
// ridge, so its time is the weight stream (12.6 MB for granite's QKV weight,
// 67 MB for its gate+up weight).  Design: a CTA owns a 64-column tile of the
// weight for up to GEMM_MROWS rows (one row block at decode; a dW GEMM's
// 2048 rows make 32), each thread streams 16-byte vectors (8 columns of one
// weight row) four k rows a step, the next step's four loaded before this
// step's FMAs (with one step's loads only, the GEMM's time moved 5-11% with
// whatever else the bundle kernel held), x sits in shared memory, sums stay
// fp32.  A gated epilogue needs gate column j and up column j+F in one CTA,
// so the gated tile is 32 gate columns plus their 32 up columns.
//
// RMSNorm, the activation and the residual add take bf16 or, with i[6] = 1,
// fp32 rows.  All three are bound by bytes.  The residual add streams its
// (M, F) operands in 16-byte vectors, 16 KB of each operand per CTA, every
// load of a thread issued before its first add.
//
// fp32 GEMM (i[6] = 1, the MoE router: 8 x 4096 @ 4096 x 16 at phi3.5-moe):
// x, w and out fp32.  A CTA owns 64 columns and one of i[7] slices of K (the
// router's N = 16 is a quarter of one tile, so a single CTA walking all of K
// is bound by load latency: 0.19 ms on the H100).  A thread streams 16-byte
// vectors of 4 columns, reads x through the cache (a half-warp shares one x
// value), and columns past N are masked, so N needs only N % 4 == 0.  Each
// CTA writes its slice's (M, 64) partial into a per-launch workspace
// (out[1]) and takes a ticket of its column tile (out[2], zeroed); the
// tile's last CTA sums the slices in slice order, as the paper members'
// carries do, so the result is the same every launch.  With the residual
// epilogue (i[8] = 1, in[3] = res (M, N)) that CTA adds res to each column's
// sum before the store.
//
// Chains.  A chain keeps its intermediate out of device memory where the
// consumer can take it in the producer's CTA, and says so where it cannot:
//   * row-wise -> row-wise (rmsnorm, act, resadd -> rmsnorm, act, resadd,
//     AdamW's g), sub-kind ROW_CHAIN: a CTA owns a segment of the flat
//     intermediate that holds whole rows of every member that needs whole
//     rows (the norm, the gated activation's consumer side); the producer
//     writes the segment into shared memory rounded to the dtype it would
//     store, the consumer reads it there.  The flat index is the reference's
//     row-stream reshape, so a producer row of one width feeds consumer rows
//     of another (AdamW's (R, 128) rows among them).
//   * row-wise -> GEMM x (i[9]): the producer fills the GEMM's x staging
//     buffer, row by row (a norm) or element by element.
//   * GEMM -> activation or residual add: the epilogues (i[5], i[8]).
//   * GEMM -> AdamW's g (the dW -> AdamW chain, i[12] = EPI_ADAMW): each
//     product, rounded to the param dtype as the GEMM stores it (fp32: the
//     K slices' sum, in the tile's combine), updates its element of the
//     (R, 128) view of p, m, v in place; the gradient never reaches memory.
//   * GEMM -> any other row consumer (RMSNorm; fp32 activations), i[12] =
//     EPI_ROWS: the consumer needs whole rows while a GEMM CTA owns 64
//     columns, so THE INTERMEDIATE PASSES THROUGH A PER-LAUNCH WORKSPACE in
//     device memory (out[1]), stored as the GEMM stores it; every CTA takes a
//     ticket (out[2]) and the last one runs the consumer over all rows.
//
// Chain descriptor (beside the GEMM fields i[0..8]; i[4] is unused): the
// producer stage
// i[9] = sub + 1 (0: none), i[10] = its activation, i[11] = its input row
// width; i[12] = the GEMM's epilogue (EPI_*); the consumer stage i[13] =
// sub (ROW_ADAMW for the update), i[14] = its activation, i[15] = its input
// row width; f[6] = the chain's RMSNorm eps, f[0..5] = AdamW's constants.
// Pointers: in[0], in[1] the producer's operands (x or h; scale or res),
// in[2] the GEMM weight, in[3] the consumer's other operand (scale, res, or
// AdamW's scalars), in[4], in[5] AdamW's m and v (updated in place),
// out[0] the output (AdamW: p, in place), out[1], out[2] workspace and
// tickets.  ROW_CHAIN's segment length is i[1].  The stitched operand's slot
// matters to the card only for the residual add, where h + res == res + h.
//
// Bitwise contract: a chain equals its two members run separately.  Each
// element of the intermediate is computed by the producer's own code
// (rms_inv / act_apply / the fp32 add) and rounded to the stored dtype; the
// consumer applies its own code to that value; each column's K-sum runs in
// the same order whichever tile holds it; each row's RMSNorm reduction runs
// in the same thread order (rms_inv, HF_THREADS threads); the AdamW update
// is adamw_update (csrc/adamw_member.cuh); the build uses -fmad=false so no
// call site fuses a multiply-add the other does not.
//
// Registers: the chain bodies are non-inlined calls, like the fp32 GEMM,
// RMSNorm and residual add (inlined, a new row path moved ptxas's
// allocation of the whole bundle kernel and slowed the grouped expert FFN
// member by 5% on the H100): row_chain, and the bf16 GEMM's stages
// (gemm_stage_x, gemm_adamw_tile, gemm_rows_tail), called outside its K
// loop so that a chain streams its weight in the member's own loop (a
// second, non-inlined copy of the GEMM ran the W_o-shaped dW->AdamW chain
// at 1.34x its two separate launches on the H100).  Only the chain instances
// of the bundle kernel (CHAINS = true, csrc/bundle.cu) hold ROW_CHAIN, the
// EPI_* epilogues and the fp32 GEMM's staged producer (row_chain_kernel
// says which members need them); the other instances, which every launch
// without them takes, keep the allocation of the members they run.
#pragma once

#include "adamw_member.cuh"
#include "common.cuh"

enum { ROW_NORM = 0, ROW_GEMM = 1, ROW_ACT = 2, ROW_RESADD = 3, ROW_CHAIN = 4,
       ROW_ADAMW = 5 };
enum { ACT_NONE = -1, ACT_SILU_GATE = 0, ACT_GELU_GATE = 1, ACT_GELU = 2,
       ACT_RELU2 = 3 };
enum { EPI_STORE = 0, EPI_ROWS = 1, EPI_ADAMW = 2 };

#define GEMM_TN 64          // weight columns per CTA tile
#define GEMM_MB 8           // rows per pass (accumulators: GEMM_MB x 8 / thread)
#define GEMM_MROWS 64       // rows per CTA of the bf16 GEMM (row blocks)
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

// rsqrt(mean(x^2) + eps) of one row of d values, fp32; all HF_THREADS
// threads of the CTA call it; red holds HF_WARPS floats and may be written
// again only after a __syncthreads
template <typename T>
__device__ __forceinline__ float rms_inv(const T* x, int d, float eps,
                                         float* red) {
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
  return rsqrtf(tot / (float)d + eps);
}

// y = x * rsqrt(mean(x^2) + eps) * (1 + scale), fp32 math, stored as T
// (bf16 or fp32).  All HF_THREADS threads of the CTA call it.
template <typename T>
__device__ void rms_row(const T* x, const float* scale, int d, float eps,
                        T* y, float* red) {
  const float inv = rms_inv(x, d, eps, red);
  for (int k = threadIdx.x; k < d; k += HF_THREADS)
    y[k] = from_f32<T>(to_f32(x[k]) * inv * (1.0f + scale[k]));
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Row-wise chain stages over a flat range [f0, f1) of the intermediate
// ---------------------------------------------------------------------------
// The producer's output row width from its input row width
__device__ __forceinline__ int stage_width(int sub, int act, int w_in) {
  return sub == ROW_ACT && act_gated(act) ? w_in / 2 : w_in;
}

// Element (r, c) of a row-wise producer's output in fp32, before the
// member's rounding to its stored dtype: the norm (inv = rms_inv of row r),
// the activation, the residual add.  a, b: rmsnorm x, scale; act h;
// resadd h, res.
template <typename T, int SUB>
__device__ __forceinline__ float stage_elem(int act, const void* a,
                                            const void* b, int w_in, int w,
                                            long long r, int c, float inv) {
  if (SUB == ROW_NORM)
    return to_f32(static_cast<const T*>(a)[r * w + c]) * inv *
           (1.0f + static_cast<const float*>(b)[c]);
  if (SUB == ROW_ACT) {
    const T* h = static_cast<const T*>(a) + r * w_in;
    return act_apply(act, to_f32(h[c]),
                     act_gated(act) ? to_f32(h[w + c]) : 0.0f);
  }
  return to_f32(static_cast<const T*>(a)[r * w + c]) +
         to_f32(static_cast<const T*>(b)[r * w + c]);
}

template <typename T, int SUB>
__device__ __forceinline__ void produce_rows(int act, float eps,
                                             const void* a, const void* b,
                                             int w_in, long long f0,
                                             long long f1, T* dst,
                                             float* red) {
  const int w = stage_width(SUB, act, w_in);
  for (long long r = f0 / w; r * w < f1; ++r) {
    const int c0 = (int)(max(f0, r * w) - r * w);
    const int c1 = (int)(min(f1, (r + 1) * w) - r * w);
    const long long at = r * w - f0;     // dst[at + c] holds column c
    float inv = 0.0f;
    if (SUB == ROW_NORM)
      inv = rms_inv(static_cast<const T*>(a) + r * w, w, eps, red);
    // four elements' loads issued before their stores: through generic
    // pointers the compiler must assume a store to dst may feed a later load
    int c = c0 + threadIdx.x;
    for (; c + 3 * HF_THREADS < c1; c += 4 * HF_THREADS) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = stage_elem<T, SUB>(act, a, b, w_in, w, r, c + u * HF_THREADS,
                                  inv);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        dst[at + c + u * HF_THREADS] = from_f32<T>(v[u]);
    }
    for (; c < c1; c += HF_THREADS)
      dst[at + c] = from_f32<T>(stage_elem<T, SUB>(act, a, b, w_in, w, r, c,
                                                   inv));
    if (SUB == ROW_NORM) __syncthreads();  // red is written again next row
  }
  __syncthreads();
}

// Elements [f0, f1) of a row-wise producer's flat output, each as the
// member computes and stores it, into dst[0 .. f1 - f0) (shared memory).
template <typename T>
__device__ void produce_range(int sub, int act, float eps, const void* a,
                              const void* b, int w_in, long long f0,
                              long long f1, T* dst, float* red) {
  if (sub == ROW_NORM)
    produce_rows<T, ROW_NORM>(act, eps, a, b, w_in, f0, f1, dst, red);
  else if (sub == ROW_ACT)
    produce_rows<T, ROW_ACT>(act, eps, a, b, w_in, f0, f1, dst, red);
  else
    produce_rows<T, ROW_RESADD>(act, eps, a, b, w_in, f0, f1, dst, red);
}

// The consumer stage over elements [f0, f1) of the intermediate, read from
// mid[0 .. f1 - f0): whole rows of w_in for the norm and the gated
// activation, element by element for the rest.  other: the norm's scale,
// the residual add's other operand, AdamW's scalars (with m.in[4], m.in[5]
// its m and v, out its p).
template <typename T>
__device__ void consume_range(const MemberDesc& m, int kind, int act,
                              float eps, const void* other, int w_in,
                              long long f0, long long f1, const T* mid,
                              T* out, float* red) {
  if (kind == ROW_NORM) {
    for (long long r = f0 / w_in; r * w_in < f1; ++r)
      rms_row(mid + (r * w_in - f0), static_cast<const float*>(other), w_in,
              eps, out + r * w_in, red);
  } else if (kind == ROW_ACT && act_gated(act)) {
    const int F = w_in / 2;
    for (long long r = f0 / w_in; r * w_in < f1; ++r) {
      const T* h = mid + (r * w_in - f0);
      for (int j = threadIdx.x; j < F; j += HF_THREADS)
        out[r * F + j] =
            from_f32<T>(act_apply(act, to_f32(h[j]), to_f32(h[F + j])));
    }
  } else if (kind == ROW_ADAMW) {
    const AdamwK k = adamw_consts(m, static_cast<const float*>(other));
    float* mm = static_cast<float*>(const_cast<void*>(m.in[4]));
    float* vv = static_cast<float*>(const_cast<void*>(m.in[5]));
    for (long long e = f0 + threadIdx.x; e < f1; e += HF_THREADS)
      adamw_elem(k, out, mm, vv, (size_t)e, to_f32(mid[e - f0]));
  } else if (kind == ROW_ACT) {
    for (long long e = f0 + threadIdx.x; e < f1; e += HF_THREADS)
      out[e] = from_f32<T>(act_apply(act, to_f32(mid[e - f0]), 0.0f));
  } else {
    const T* res = static_cast<const T*>(other);
    for (long long e = f0 + threadIdx.x; e < f1; e += HF_THREADS)
      out[e] = from_f32<T>(to_f32(mid[e - f0]) + to_f32(res[e]));
  }
  __syncthreads();
}

// ROW_CHAIN: CTA c owns segment [c * i[1], (c + 1) * i[1]) of the flat
// intermediate, held in shared memory between the two stages
template <typename T>
__device__ __noinline__ void row_chain(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long seg = m.i[1], f0 = (long long)cta * seg;
  T* mid = reinterpret_cast<T*>(smem);
  float* red =
      reinterpret_cast<float*>(smem + hf_align16((int)(seg * sizeof(T))));
  produce_range<T>(m.i[9] - 1, m.i[10], m.f[6], m.in[0], m.in[1], m.i[11],
                   f0, f0 + seg, mid, red);
  consume_range<T>(m, m.i[13], m.i[14], m.f[6], m.in[3], m.i[15], f0,
                   f0 + seg, mid, static_cast<T*>(m.out[0]), red);
}

// ---------------------------------------------------------------------------
// bf16 GEMM
// ---------------------------------------------------------------------------
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

// The bf16 GEMM's chain stages, each a call (see the header):
// rows [m0, m0 + mb) of a row-wise producer's output staged as x
__device__ __noinline__ void gemm_stage_x(const MemberDesc& m, int m0, int mb,
                                          bf16* xs, float* red) {
  const long long K = m.i[2];
  produce_range<bf16>(m.i[9] - 1, m.i[10], m.f[6], m.in[0], m.in[1], m.i[11],
                      m0 * K, (m0 + mb) * K, xs, red);
}

// EPI_ADAMW: the pass's (mb, 64) tile of the product, rounded as the GEMM
// stores it, is the gradient of elements (m0 + r) * N + col of AdamW's
// (R, 128) view
__device__ __noinline__ void gemm_adamw_tile(const MemberDesc& m,
                                             const float* tile, int m0,
                                             int mb, int tn) {
  const int N = m.i[3];
  const AdamwK k = adamw_consts(m, static_cast<const float*>(m.in[3]));
  bf16* p = static_cast<bf16*>(m.out[0]);
  float* mm = static_cast<float*>(const_cast<void*>(m.in[4]));
  float* vv = static_cast<float*>(const_cast<void*>(m.in[5]));
  for (int idx = threadIdx.x; idx < mb * GEMM_TN; idx += HF_THREADS) {
    const int r = idx / GEMM_TN, c = idx % GEMM_TN;
    adamw_elem(k, p, mm, vv, (size_t)(m0 + r) * N + tn * GEMM_TN + c,
               bf_round(tile[idx]));
  }
}

// EPI_ROWS: after every CTA stored its product into the workspace, the last
// runs the consumer over all rows
__device__ __noinline__ void gemm_rows_tail(const MemberDesc& m, float* red) {
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), 0, m.ctas)) return;
  consume_range<bf16>(m, m.i[13], m.i[14], m.f[6], m.in[3], m.i[15], 0,
                      (long long)m.i[1] * m.i[3],
                      static_cast<const bf16*>(m.out[1]),
                      static_cast<bf16*>(m.out[0]), red);
}

// out(M, N or F) = epilogue(prologue(x)(M, K) @ w(K, N)); CTA c owns column
// tile c % (N / 64) of row block c / (N / 64).  One body for the member and
// every chain through it: the chain stages are the calls above, outside
// the K loop; CHAINS compiles in the EPI_* epilogues.
template <bool CHAINS>
__device__ void row_gemm(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = m.i[1], K = m.i[2], N = m.i[3];
  const int act = m.i[5];
  const bf16* x = static_cast<const bf16*>(m.in[0]);
  const bf16* w = static_cast<const bf16*>(m.in[2]);
  bf16* out = static_cast<bf16*>(m.out[0]);
  const bool gated = act_gated(act);
  const int F = N / 2;
  const int ntile = N / GEMM_TN, tn = cta % ntile;
  const int r0 = cta / ntile * GEMM_MROWS, r1 = min(M, r0 + GEMM_MROWS);

  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + hf_align16(GEMM_MB * K * 2));
  float* tile = red + HF_WARPS * GEMM_MB * GEMM_TN;
  float* nred = tile + GEMM_MB * GEMM_TN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & 7;       // this thread's 8-column group in the tile
  const int kr = tid >> 3;      // this thread's k residue mod 32
  int col0;
  if (gated)
    col0 = (cg < 4) ? tn * (GEMM_TN / 2) + cg * 8
                    : F + tn * (GEMM_TN / 2) + (cg - 4) * 8;
  else
    col0 = tn * GEMM_TN + cg * 8;

  for (int m0 = r0; m0 < r1; m0 += GEMM_MB) {
    const int mb = min(GEMM_MB, r1 - m0);
    if (m.i[9]) {
      gemm_stage_x(m, m0, mb, xs, nred);
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

    // steps of four weight vectors, the next step's loaded before this
    // step's FMAs; k ascends in both loops, so every column's sum runs in
    // one fixed order
    int k = kr;
    if (k + 96 < K) {
      uint4 wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wv[u] = *reinterpret_cast<const uint4*>(w + (size_t)(k + 32 * u) * N +
                                                col0);
      for (;;) {
        const int kn = k + 128;
        const bool more = kn + 96 < K;
        uint4 nv[4];
        if (more) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            nv[u] = *reinterpret_cast<const uint4*>(
                w + (size_t)(kn + 32 * u) * N + col0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) gemm_fma(acc, xs, K, k + 32 * u, mb, wv[u]);
        k = kn;
        if (!more) break;
#pragma unroll
        for (int u = 0; u < 4; ++u) wv[u] = nv[u];
      }
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
        out[(size_t)(m0 + r) * F + tn * (GEMM_TN / 2) + c] =
            f2bf(act_apply(act, a, b));
      }
    } else if (CHAINS && m.i[12] == EPI_ADAMW) {
      gemm_adamw_tile(m, tile, m0, mb, tn);
    } else {
      // read here, not live across the K loop; EPI_ROWS stores the
      // product into the workspace instead of out
      const bf16* res = m.i[8] ? static_cast<const bf16*>(m.in[3]) : nullptr;
      bf16* dst =
          CHAINS && m.i[12] == EPI_ROWS ? static_cast<bf16*>(m.out[1]) : out;
      for (int idx = tid; idx < mb * GEMM_TN; idx += HF_THREADS) {
        const int r = idx / GEMM_TN, c = idx % GEMM_TN;
        const size_t o = (size_t)(m0 + r) * N + tn * GEMM_TN + c;
        const float h = tile[idx];
        dst[o] = f2bf(res ? bf_round(h) + bf2f(res[o])
                      : act == ACT_NONE ? h
                                        : act_apply(act, bf_round(h), 0.0f));
      }
    }
    __syncthreads();
  }
  if (CHAINS && m.i[12] == EPI_ROWS) gemm_rows_tail(m, nred);
}

// ---------------------------------------------------------------------------
// fp32 GEMM: out(M, N) = x(M, K) @ w(K, N), every operand fp32, split over
// i[7] slices of K
// ---------------------------------------------------------------------------
#define GEMM_F32_KR 16      // k residues (threads per column group)
#define F32_KSLICE 64       // K rows per slice (kernels/row.py F32_K_SLICE)

__host__ __device__ inline int gemm_f32_smem_bytes(bool chain) {
  return HF_WARPS * GEMM_MB * GEMM_TN * 4 +
         (chain ? GEMM_MB * F32_KSLICE * 4 + HF_WARPS * 4 : 0);
}

// STAGED (a row-wise producer's chain, i[9]): this CTA's slice [k0, k1) of
// the pass's x rows, computed by the producer into shared memory; a norm
// row by row (each needs its 1/rms), the rest in one loop
__device__ __forceinline__ void gemm_f32_stage(const MemberDesc& m, int m0,
                                               int mb, int k0, int k1,
                                               float* xs, float* red) {
  const long long K = m.i[2];
  const int sub = m.i[9] - 1, act = m.i[10], w_in = m.i[11];
  if (sub == ROW_NORM) {
    for (int r = 0; r < mb; ++r)
      produce_range<float>(sub, act, m.f[6], m.in[0], m.in[1], w_in,
                           (m0 + r) * K + k0, (m0 + r) * K + k1,
                           xs + r * F32_KSLICE, red);
    return;
  }
  const int w = stage_width(sub, act, w_in), kc = k1 - k0;
  for (int idx = threadIdx.x; idx < mb * kc; idx += HF_THREADS) {
    const int r = idx / kc;
    const long long f = (m0 + r) * K + k0 + idx % kc;
    xs[r * F32_KSLICE + idx % kc] =
        sub == ROW_ACT
            ? stage_elem<float, ROW_ACT>(act, m.in[0], m.in[1], w_in, w,
                                         f / w, (int)(f % w), 0.0f)
            : stage_elem<float, ROW_RESADD>(act, m.in[0], m.in[1], w_in, w,
                                            f / w, (int)(f % w), 0.0f);
  }
  __syncthreads();
}

// Not inlined: inlined, its split-K bookkeeping made ptxas spill inside the
// 128-register bundle kernel; as a call it spills nothing itself and the
// other members keep their allocation.  STAGED: a row-wise producer stages
// this slice of x (i[9]).  The chain epilogues run in the combine, after
// the K loop: AdamW (EPI_ADAMW) or the workspace of a row consumer
// (EPI_ROWS: the combined product after the K slices' partials in out[1],
// its ticket after the tiles' in out[2]).
template <bool STAGED>
__device__ __noinline__ void row_gemm_f32(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = m.i[1], K = m.i[2], N = m.i[3], KS = m.i[7];
  const float* x = static_cast<const float*>(m.in[0]);
  const float* w = static_cast<const float*>(m.in[2]);
  const float* res = m.i[8] ? static_cast<const float*>(m.in[3]) : nullptr;
  float* out = static_cast<float*>(m.out[0]);
  float* ws = static_cast<float*>(m.out[1]);
  float* red = reinterpret_cast<float*>(smem);
  float* xs = red + HF_WARPS * GEMM_MB * GEMM_TN;      // STAGED: x's slice
  float* nred = xs + GEMM_MB * F32_KSLICE;

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
    if (STAGED) gemm_f32_stage(m, m0, mb, k0, k1, xs, nred);
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
            const float xv = STAGED ? xs[r * F32_KSLICE + k - k0]
                                    : x[(size_t)(m0 + r) * K + k];
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
  const int epi = m.i[12];
  float* mid = ws + (size_t)KS * M * N;         // EPI_ROWS: the product
  for (int idx = tid; idx < M * GEMM_TN; idx += HF_THREADS) {
    const int r = idx / GEMM_TN, col = tile * GEMM_TN + idx % GEMM_TN;
    if (col < N) {
      float s = ws[(size_t)r * N + col];
      for (int q = 1; q < KS; ++q) s += ws[((size_t)q * M + r) * N + col];
      if (res) s += res[(size_t)r * N + col];
      if (epi == EPI_ADAMW)
        adamw_elem(adamw_consts(m, static_cast<const float*>(m.in[3])), out,
                   static_cast<float*>(const_cast<void*>(m.in[4])),
                   static_cast<float*>(const_cast<void*>(m.in[5])),
                   (size_t)r * N + col, s);
      else
        (epi == EPI_ROWS ? mid : out)[(size_t)r * N + col] = s;
    }
  }
  if (epi != EPI_ROWS) return;
  // the last tile to finish runs the consumer over the whole product
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), ntile, ntile)) return;
  consume_range<float>(m, m.i[13], m.i[14], m.f[6], m.in[3], m.i[15], 0,
                       (long long)M * N, mid, out, nred);
}

// ---------------------------------------------------------------------------
// Activation, residual add, RMSNorm alone
// ---------------------------------------------------------------------------
// h (M, F_in) -> out (M, F_out), T = bf16 or fp32
template <typename T>
__device__ void row_act(const MemberDesc& m, int cta) {
  const int M = m.i[1], F_in = m.i[2], F_out = m.i[3], act = m.i[5];
  const T* h = static_cast<const T*>(m.in[0]);
  T* out = static_cast<T*>(m.out[0]);
  const int nchunk = (F_out + ACT_COLS - 1) / ACT_COLS;
  const int r = cta / nchunk, c0 = (cta % nchunk) * ACT_COLS;
  if (r >= M) return;
  const bool gated = act_gated(act);
  for (int j = c0 + threadIdx.x; j < min(F_out, c0 + ACT_COLS);
       j += HF_THREADS) {
    const float a = to_f32(h[(size_t)r * F_in + j]);
    const float b = gated ? to_f32(h[(size_t)r * F_in + F_out + j]) : 0.0f;
    out[(size_t)r * F_out + j] = from_f32<T>(act_apply(act, a, b));
  }
}

__device__ __noinline__ void row_act_f32(const MemberDesc& m, int cta) {
  row_act<float>(m, cta);
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

// an fp32 GEMM descriptor that uses the chain paths (staged producer, EPI_*)
__host__ __device__ __forceinline__ bool gemm_chained(const MemberDesc& m) {
  return m.i[9] != 0 || m.i[12] != EPI_STORE;
}

// a row member that only the chain instance of the bundle kernel runs: a
// row-wise pair, a GEMM epilogue into a row consumer or AdamW, an fp32
// GEMM's staged producer
__host__ __device__ inline bool row_chain_kernel(const MemberDesc& m) {
  return m.i[0] == ROW_CHAIN ||
         (m.i[0] == ROW_GEMM && (m.i[12] != EPI_STORE || (m.i[6] && m.i[9])));
}

template <bool CHAINS>
__device__ void row_member(const MemberDesc& m, int cta) {
  switch (m.i[0]) {
    case ROW_NORM:
      if (m.i[6])
        row_norm_f32(m, cta);
      else
        row_norm<bf16>(m, cta);
      break;
    case ROW_GEMM:
      if (!m.i[6])
        row_gemm<CHAINS>(m, cta);
      else if (CHAINS && m.i[9])
        row_gemm_f32<true>(m, cta);
      else
        row_gemm_f32<false>(m, cta);
      break;
    case ROW_RESADD:
      if (m.i[6])
        row_resadd<float>(m, cta);
      else
        row_resadd<bf16>(m, cta);
      break;
    case ROW_CHAIN:
      if constexpr (CHAINS) {
        if (m.i[6])
          row_chain<float>(m, cta);
        else
          row_chain<bf16>(m, cta);
      }
      break;
    default:
      if (m.i[6])
        row_act_f32(m, cta);
      else
        row_act<bf16>(m, cta);
      break;
  }
}

__host__ __device__ inline int row_smem_bytes(const MemberDesc& m) {
  switch (m.i[0]) {
    case ROW_NORM: return HF_WARPS * 4;
    case ROW_GEMM: return m.i[6] ? gemm_f32_smem_bytes(gemm_chained(m))
                                 : gemm_smem_bytes(m.i[2]);
    case ROW_CHAIN:
      return hf_align16(m.i[1] * (m.i[6] ? 4 : 2)) + HF_WARPS * 4;
    default: return 0;   // activation, residual add
  }
}
