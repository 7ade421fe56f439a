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
// 67 MB for its gate+up weight); a dW GEMM (2048 rows) is bound by
// operations.  Design of the bf16 GEMM (row_gemm_mma):
//   * every SM busy: a CTA owns a 128-column tile of the weight, a row block
//     of 8, 16, 32 or 64 rows and one of i[7] slices of K, so qkv_proj at
//     decode runs 24 tiles x 6 slices = 144 CTAs (kernels/row.py
//     RowMember.k_slice: the fewest slices that give every SM one CTA; on
//     the H100 one CTA an SM streams as fast as two) and each CTA's six
//     stages are all but one in flight at once; the tile's last CTA sums the
//     slices' fp32 partials in slice order and runs the epilogue;
//   * the tensor cores: mma.sync.m16n8k16, the weight's 16 columns on the
//     16-row side and 8 token rows on the 8-column side, so 8 decode rows
//     fill an mma with no padding (as csrc/moe_gmm_member.cuh does); fp32
//     accumulators;
//   * the stream: 64-row stages of the weight (and of x) through a ring of 3
//     to 5 stages by cp.async, 2 to 4 stages (35-79 KB) in flight a CTA,
//     each weight row read as 256 contiguous bytes (a gated tile: two runs
//     of 128); wider tiles (256, 512 columns) ran slower on the H100;
//   * each weight stage is applied to the whole row block, so the weight
//     leaves memory once a row block, not once every 8 rows.
// A gated epilogue needs gate column j and up column j+F in one CTA, so the
// gated tile is 64 gate columns plus their 64 up columns.
//
// RMSNorm, the activation and the residual add take bf16 or, with i[6] = 1,
// fp32 rows.  All three are bound by bytes.  The residual add streams its
// (M, F) operands in 16-byte vectors, 16 KB of each operand per CTA, every
// load of a thread issued before its first add.  RMSNorm alone (row_norm)
// is one warp a row, i[4] rows a CTA (kernels/row.py norm_rows: 1 at decode
// sizes, 8 at 8192 rows): a row of up to 4096 bf16 or 2048 fp32 is loaded
// in 16-byte vectors into the lane's registers, all loads in flight before
// the first use, reduced with warp shuffles (no shared memory, no
// __syncthreads), then scaled and stored from the same registers, so x
// leaves memory once.
//
// fp32 GEMM (i[6] = 1: the MoE router, 8 x 4096 @ 4096 x 16 at phi3.5-moe;
// the fp32 chains, among them the dW -> AdamW of the stacked norm scales,
// 40 x 8192 @ 8192 x 2048): x, w and out fp32, fmaf on the CUDA cores.
// Bound by bytes at every shape a path launches (M 8..40 rows do 2 M flops
// per 4-byte weight element).  Design (row_gemm_f32):
//   * every SM busy: a CTA owns a 64-column tile and one of i[7] slices of
//     i[4] K rows, the fewest slices that bring tiles x slices to 132 CTAs
//     (kernels/row.py RowMember.k_slice), so W_o and the dW take 160 CTAs
//     and the router 64 (K allows no more); the partials a split writes
//     are (slices, M, N): 1.6 MB at the dW, not the weight's size;
//   * the weight streams once a pass: 64-row stages (16 KB) through a ring
//     of 3..8 stages by cp.async, x beside it, every stage applied to all
//     the pass's rows (up to 128: M 40 is one pass) before it is released;
//     rows are spread over threads (8 a thread) and what the rows leave of
//     the 256 threads takes k residues of the stage (all 256 threads work
//     at M 8, 240 at M 40); a tile narrower than 64 columns
//     (the router's 16) gives its idle column threads more k residues;
//   * the tile's last CTA sums the slices in slice order (8 loads in
//     flight), so the result is the same every launch; the residual add
//     (i[8] = 1, in[3] = res (M, N)) and the chain epilogues run there, on
//     the sum; columns past N are masked, so N needs only N % 4 == 0.
// Its partials and tickets persist in a workspace like the bf16 GEMM's.
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
//     buffer with the CTA's K slice, gemm_xc (fp32: F32Geo.xc) columns at a
//     time; a norm first reduces each whole row for its 1/rms, one warp a
//     row (rms_inv_warp).
//   * GEMM -> activation or residual add: the epilogues (i[5], i[8]).
//   * GEMM -> AdamW's g (the dW -> AdamW chain, i[12] = EPI_ADAMW): each
//     product, rounded to the param dtype as the GEMM stores it (fp32: the
//     K slices' sum, in the tile's combine), updates its element of the
//     (R, 128) view of p, m, v in place; the gradient never reaches memory.
//   * GEMM -> any other row consumer (RMSNorm; fp32 activations), i[12] =
//     EPI_ROWS: the consumer needs whole rows while a GEMM CTA owns 64 or
//     128 columns, so THE INTERMEDIATE PASSES THROUGH A WORKSPACE in device
//     memory (out[3]), stored as the GEMM stores
//     it; the CTA that finishes each tile takes a ticket (out[2]) and the
//     last one runs the consumer over all rows.
//
// RMSNorm descriptor: i[1], i[2] = M, d, i[4] = rows a CTA, f[0] = eps.
// GEMM descriptor: i[1..3] = M, K, N, i[4] = rows of a K slice (a multiple
// of GEMM_KT, fp32 of F32_KT), i[5] = the activation epilogue, i[6] = fp32,
// i[7] = K slices, i[8] = the residual epilogue.  Chain descriptor (beside
// them): the producer stage i[9] = sub + 1 (0: none), i[10] = its
// activation, i[11] = its input row width; i[12] = the GEMM's epilogue
// (EPI_*); the consumer stage i[13] = sub (ROW_ADAMW for the update), i[14]
// = its activation, i[15] = its input row width; f[6] = the chain's
// RMSNorm eps, f[0..5] = AdamW's constants.
// Pointers: in[0], in[1] the producer's operands (x or h; scale or res),
// in[2] the GEMM weight, in[3] the consumer's other operand (scale, res, or
// AdamW's scalars), in[4], in[5] AdamW's m and v (updated in place),
// out[0] the output (AdamW: p, in place), out[1] the K slices' fp32
// partials, out[2] tickets (they persist across launches: the CTA that
// draws the last resets it), out[3] the EPI_ROWS product.  ROW_CHAIN's segment length is i[1].  The stitched operand's slot
// matters to the card only for the residual add, where h + res == res + h.
//
// Bitwise contract: a chain equals its two members run separately.  Each
// element of the intermediate is computed by the producer's own code
// (x * inv * (1 + scale) / act_apply / the fp32 add) and rounded to the
// stored dtype; the consumer applies its own code to that value; each
// column's K-sum runs in the same order whichever tile, position or row
// block holds it; each row's RMSNorm reduction runs in one order, one warp
// a row, whichever body and rows per CTA take it (see "RMSNorm's one
// reduction order" below); the AdamW update is adamw_update
// (csrc/adamw_member.cuh); the build uses -fmad=false so no call site fuses
// a multiply-add the other does not.
//
// Registers: the chain bodies are non-inlined calls, like the fp32 GEMM
// (row_gemm_f32<STAGED>, its producer stage inlined into <true>: as a call
// inside the K loop it made the body spill more and ran the staged chains
// slower on the H100),
// RMSNorm (row_norm<bf16|float>) and the residual add (inlined, a new row
// path moved ptxas's allocation of the whole bundle kernel and slowed the
// grouped expert FFN member by 5% on the H100): row_chain, the bf16 GEMM's body
// (row_gemm_mma, one per row-block size) and its stages (gemm_stage_inv,
// gemm_stage_x, gemm_adamw_tile, gemm_rows_tail), so that a chain streams its weight in
// the member's own loop (a second, non-inlined copy of the GEMM ran the
// W_o-shaped dW->AdamW chain at 1.34x its two separate launches on the
// H100).  Only the chain instances
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

#define GEMM_TN 64          // weight columns per CTA tile of the fp32 GEMM
// the bf16 GEMM (kernels/row.py): a CTA's tile of weight columns, 16 a warp
// (wider tiles, 256 and 512, streamed slower on the H100), and the k rows
// of a ring stage; row strides of a staged weight and x slice 16 bytes past
// a multiple of 128, so the 8 rows an ldmatrix reads fall in 8 bank groups
#define GEMM_BN 128
#define GEMM_KT 64
#define GEMM_LDW (GEMM_BN + 8)
#define GEMM_LDX (GEMM_KT + 8)
#define GEMM_W_BYTES (GEMM_KT * GEMM_LDW * 2)
// vectors a lane of a GEMM prologue's 1/rms loads at once (gemm_stage_inv;
// gemm_stage_x's reshaped rows): few, because the registers of those
// non-inlined stages are registers the row_gemm_mma bodies must keep clear
#define GEMM_INV_CHUNK 4
#define GEMM_STAGE_CHUNK 2  // (and its EPI_ROWS tail's)
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

// ---------------------------------------------------------------------------
// RMSNorm's one reduction order
// ---------------------------------------------------------------------------
// Every 1/rms in this file is one warp's, in one order: element k of a row
// belongs to lane (k / V) % 32, V = 16 / sizeof(T) the elements of a
// 16-byte vector (8 bf16, 4 fp32); the lane adds the squares of its
// elements in k order (fmaf), warp_sum adds the 32 lanes' sums in its
// butterfly order, and 1/rms = rsqrtf(sum / d + eps).  The standalone
// member (whatever rows a CTA holds), every chain's norm stage and the GEMM
// prologues run it, so a chain gives each row the bits its members give
// (the bitwise contract).  A row whose start is 16-byte aligned is read in
// 16-byte vectors, the part vector past the last whole one element by
// element; any other row (d * sizeof(T) % 16 != 0 puts most rows there)
// element by element, in the same order.
#define NORM_VECS 16        // 16-byte vectors a lane of the standalone
                            // member holds: rows of 4096 bf16 or 2048 fp32
                            // leave memory once
#define NORM_CHUNK 8        // vectors a lane of rms_inv_warp loads at once
                            // (its default; the order does not depend on it)

template <typename T>
__host__ __device__ constexpr int norm_v() { return 16 / (int)sizeof(T); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the lane's vectors j0 + lane + 32 u (u < U) of row x, those below nv (its
// whole vectors), all loads issued before the first use
template <typename T, int U>
__device__ __forceinline__ void norm_load(const T* x, int j0, int nv,
                                          uint4 (&v)[U]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + lane + 32 * u;
    v[u] = j < nv ? reinterpret_cast<const uint4*>(x)[j]
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ss plus the squares of the vectors norm_load gave, in element order
template <typename T, int U>
__device__ __forceinline__ float norm_sumsq(const uint4 (&v)[U], int j0,
                                            int nv, float ss) {
  constexpr int V = norm_v<T>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (j0 + lane + 32 * u < nv) {
      float f[V];
      unpack16<T>(v[u], f);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
  return ss;
}

// ss plus the squares of elements [k0, k1) of x, in order
template <typename T>
__device__ __forceinline__ float norm_sumsq_elems(const T* x, int k0, int k1,
                                                  float ss) {
  for (int k = k0; k < k1; ++k) {
    const float f = to_f32(x[k]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// the lane's part vector (elements past the last whole vector: the last of
// its lane's elements) and, for a row that is not 16-byte aligned, all of
// the lane's elements one by one
template <typename T>
__device__ __forceinline__ float norm_sumsq_rest(const T* x, int d,
                                                 bool vec, float ss) {
  constexpr int V = norm_v<T>();
  const int lane = threadIdx.x & 31, nv = d / V;
  if (vec) return lane == nv % 32 ? norm_sumsq_elems(x, nv * V, d, ss) : ss;
  for (int j = lane; j * V < d; j += 32)
    ss = norm_sumsq_elems(x, j * V, min(d, j * V + V), ss);
  return ss;
}

__device__ __forceinline__ float norm_inv(float ss, int d, float eps) {
  return rsqrtf(warp_sum(ss) / (float)d + eps);
}

// 1/rms of row x (d values of T, in global or shared memory) by the calling
// warp, all 32 lanes, in the order above; U vectors a lane in flight at
// once.  Inlined, U chosen per site: the registers the bf16 GEMM's
// non-inlined prologue stages use are registers every row_gemm_mma body
// must keep clear across the call (more of them made ptxas spill more in
// those bodies).
template <typename T, int U = NORM_CHUNK>
__device__ __forceinline__ float rms_inv_warp(const T* x, int d, float eps) {
  const bool vec = aligned16(x);
  float ss = 0.0f;
  if (vec) {
    const int nv = d / norm_v<T>();
    for (int j0 = 0; j0 < nv; j0 += 32 * U) {
      uint4 v[U];
      norm_load<T, U>(x, j0, nv, v);
      ss = norm_sumsq<T, U>(v, j0, nv, ss);
    }
  }
  return norm_inv(norm_sumsq_rest(x, d, vec, ss), d, eps);
}

// (1 + scale)'s d values into L1 while a row's x is in flight, thread t of
// the n calling threads taking 128-byte lines t, t + n, ..: the scale pass
// after the reduction then waits on L1, not on device memory
__device__ __forceinline__ void norm_prefetch(const float* scale, int d,
                                              int t, int n) {
  for (int c = 32 * t; c < d; c += 32 * n)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(scale + c));
}

// RMSNorm of `rows` whole rows of d at x into y by the whole CTA: warp w
// reduces row r0 + w of each group of HF_WARPS rows, then every thread
// scales the group's elements; red holds HF_WARPS floats
template <typename T, int U>
__device__ void norm_rows_cta(const T* x, const float* scale, int d,
                              float eps, int rows, T* y, float* red) {
  const int warp = threadIdx.x >> 5;
  norm_prefetch(scale, d, threadIdx.x, HF_THREADS);
  for (int r0 = 0; r0 < rows; r0 += HF_WARPS) {
    const int n = min(HF_WARPS, rows - r0);
    if (warp < n) {
      const float inv =
          rms_inv_warp<T, U>(x + (long long)(r0 + warp) * d, d, eps);
      if ((threadIdx.x & 31) == 0) red[warp] = inv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * d; e += HF_THREADS) {
      const int r = e / d, c = e - r * d;
      const long long o = (long long)(r0 + r) * d + c;
      y[o] = from_f32<T>(to_f32(x[o]) * red[r] * (1.0f + scale[c]));
    }
    __syncthreads();
  }
}

// y's 16-byte vector = x's vector v * inv * (1 + s), s its V scale values
// (16-byte aligned)
template <typename T>
__device__ __forceinline__ void norm_store16(const uint4& v, const float* s,
                                             float inv, T* y) {
  constexpr int V = norm_v<T>();
  float f[V];
  unpack16<T>(v, f);
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float4 sv = *reinterpret_cast<const float4*>(s + e);
    f[e] = f[e] * inv * (1.0f + sv.x);
    f[e + 1] = f[e + 1] * inv * (1.0f + sv.y);
    f[e + 2] = f[e + 2] * inv * (1.0f + sv.z);
    f[e + 3] = f[e + 3] * inv * (1.0f + sv.w);
  }
  store16(y, f);
}

// ---------------------------------------------------------------------------
// Row-wise chain stages over a flat range [f0, f1) of the intermediate
// ---------------------------------------------------------------------------
// The producer's output row width from its input row width
__device__ __forceinline__ int stage_width(int sub, int act, int w_in) {
  return sub == ROW_ACT && act_gated(act) ? w_in / 2 : w_in;
}

// Element (r, c) of a row-wise producer's output in fp32, before the
// member's rounding to its stored dtype: the norm (inv: row r's 1/rms),
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

// A norm's rows are taken HF_WARPS at a time: warp w reduces row rb + w of
// the group (rms_inv_warp, U vectors a lane at once, into red[w]) before
// any of them is produced.  Element f lands in dst[f - f0], or
// dst[(f - f0) * ld] when STRIDED.
template <typename T, int SUB, int U, bool STRIDED>
__device__ __forceinline__ void produce_rows(int act, float eps,
                                             const void* a, const void* b,
                                             int w_in, long long f0,
                                             long long f1, T* dst,
                                             float* red, int ld) {
  const int w = stage_width(SUB, act, w_in);
  if (!STRIDED) ld = 1;
  if (SUB == ROW_NORM)
    norm_prefetch(static_cast<const float*>(b), w, threadIdx.x, HF_THREADS);
  for (long long rb = f0 / w; rb * w < f1; rb += HF_WARPS) {
    if (SUB == ROW_NORM) {
      const long long r = rb + (threadIdx.x >> 5);
      if (r * w < f1) {
        const float inv =
            rms_inv_warp<T, U>(static_cast<const T*>(a) + r * w, w, eps);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = inv;
      }
      __syncthreads();
    }
    for (long long r = rb; r < rb + HF_WARPS && r * w < f1; ++r) {
      const int c0 = (int)(max(f0, r * w) - r * w);
      const int c1 = (int)(min(f1, (r + 1) * w) - r * w);
      const long long at = r * w - f0;     // dst[at + c] holds column c
      const float inv = SUB == ROW_NORM ? red[r - rb] : 0.0f;
      // four elements' loads issued before their stores: through generic
      // pointers the compiler must assume a store to dst may feed a later
      // load
      int c = c0 + threadIdx.x;
      for (; c + 3 * HF_THREADS < c1; c += 4 * HF_THREADS) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = stage_elem<T, SUB>(act, a, b, w_in, w, r,
                                    c + u * HF_THREADS, inv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[(at + c + u * HF_THREADS) * ld] = from_f32<T>(v[u]);
      }
      for (; c < c1; c += HF_THREADS)
        dst[(at + c) * ld] = from_f32<T>(
            stage_elem<T, SUB>(act, a, b, w_in, w, r, c, inv));
    }
    if (SUB == ROW_NORM) __syncthreads();  // red is written again next group
  }
  __syncthreads();
}

// Elements [f0, f1) of a row-wise producer's flat output, each as the
// member computes and stores it, into dst[0 .. f1 - f0) (shared memory; ld
// elements apart when STRIDED: the fp32 GEMM stages x transposed).
template <typename T, int U = NORM_CHUNK, bool STRIDED = false>
__device__ void produce_range(int sub, int act, float eps, const void* a,
                              const void* b, int w_in, long long f0,
                              long long f1, T* dst, float* red, int ld = 1) {
  if (sub == ROW_NORM)
    produce_rows<T, ROW_NORM, U, STRIDED>(act, eps, a, b, w_in, f0, f1, dst,
                                          red, ld);
  else if (sub == ROW_ACT)
    produce_rows<T, ROW_ACT, U, STRIDED>(act, eps, a, b, w_in, f0, f1, dst,
                                         red, ld);
  else
    produce_rows<T, ROW_RESADD, U, STRIDED>(act, eps, a, b, w_in, f0, f1,
                                            dst, red, ld);
}

// The consumer stage over elements [f0, f1) of the intermediate, read from
// mid[0 .. f1 - f0): whole rows of w_in for the norm and the gated
// activation, element by element for the rest.  other: the norm's scale,
// the residual add's other operand, AdamW's scalars (with m.in[4], m.in[5]
// its m and v, out its p).
template <typename T, int U = NORM_CHUNK>
__device__ void consume_range(const MemberDesc& m, int kind, int act,
                              float eps, const void* other, int w_in,
                              long long f0, long long f1, const T* mid,
                              T* out, float* red) {
  if (kind == ROW_NORM) {
    // [f0, f1) holds whole rows
    norm_rows_cta<T, U>(mid, static_cast<const float*>(other), w_in, eps,
                  (int)((f1 - f0) / w_in), out + f0, red);
    return;                       // norm_rows_cta ends in a __syncthreads
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
// rows of a CTA's row block: 8 * gemm_nt(M) (kernels/row.py gemm_rows)
__host__ __device__ inline int gemm_nt(int M) {
  return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
}
// ring stages per row-block size (80-104 KB of shared memory: 2 CTAs an SM)
__host__ __device__ constexpr int gemm_stages(int nt) {
  return nt <= 2 ? 5 : nt == 4 ? 4 : 3;
}
// x columns a prologue stages at once, per row (a multiple of GEMM_KT)
__host__ __device__ inline int gemm_xc(int nt) {
  return nt == 8 ? 256 : 1024 / nt;
}
// a ring stage: the weight slice [GEMM_KT][GEMM_LDW] | x's slice [8 nt]
// [GEMM_LDX] (streamed; a prologue stages x apart)
__host__ __device__ inline int gemm_stage_bytes(int nt, bool staged) {
  return GEMM_W_BYTES + (staged ? 0 : 8 * nt * GEMM_LDX * 2);
}
// ring | a prologue's x [8 nt][gemm_xc + 8] | 64 floats (a norm's 1/rms per
// row, its reduction scratch); the summed (8 nt, GEMM_BN) fp32 tile reuses
// the ring after the K loop
__host__ __device__ inline int gemm_smem_bytes(const MemberDesc& m) {
  const int nt = gemm_nt(m.i[1]);
  const bool staged = m.i[9] != 0;
  return gemm_stages(nt) * gemm_stage_bytes(nt, staged) +
         (staged ? 8 * nt * (gemm_xc(nt) + 8) * 2 : 0) + 64 * 4;
}

// The bf16 GEMM's chain stages, each a call (see the header).
// A norm prologue's 1/rms of the block's rows, one warp a row, into inv
__device__ __noinline__ void gemm_stage_inv(const MemberDesc& m, int r0,
                                            int rows, float* inv) {
  const long long K = m.i[2];
  for (int r = threadIdx.x >> 5; r < rows; r += HF_WARPS) {
    const float v = rms_inv_warp<bf16, GEMM_INV_CHUNK>(
        static_cast<const bf16*>(m.in[0]) + (r0 + r) * K, (int)K, m.f[6]);
    if ((threadIdx.x & 31) == 0) inv[r] = v;
  }
  __syncthreads();
}

// x rows [r0, r0 + rows), columns [kc0, kc1), of a row-wise producer's
// output, each element as the producer computes and stores it (stage_elem's
// arithmetic: a norm's row scaled by inv), into xs (row stride ld); zeros in
// the block's other rows and past kc1 up to the next whole stage of kt
// rows, so every slice the K loop reads is finite.  Eight columns a thread
// at a time in 16-byte vectors (K, kc0 and kc1 are multiples of 8); a
// thread's four vectors' operands are all loaded (addresses clamped into
// the operands) before the first is used, so their latencies overlap.
template <int SUB>
__device__ void gemm_stage_block(const MemberDesc& m, int r0, int rows,
                                 int R, int kt, int kc0, int kc1, bf16* xs,
                                 int ld, const float* inv) {
  constexpr int U = 4;
  const long long K = m.i[2];
  const int w = kc1 - kc0, wv = (w + kt - 1) / kt * kt / 8, act = m.i[10];
  const long long w_in = m.i[11];
  const bf16* a = static_cast<const bf16*>(m.in[0]);
  const long long boff = SUB == ROW_ACT && act_gated(act) ? K : 0;
  for (int i0 = threadIdx.x; i0 < R * wv; i0 += U * HF_THREADS) {
    uint4 va[U], vb[U];
    float4 s0[U], s1[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * HF_THREADS, r = idx / wv, c = (idx - r * wv) * 8;
      ok[u] = idx < R * wv && r < rows && c < w;
      const long long row = r0 + (ok[u] ? r : 0), col = kc0 + (ok[u] ? c : 0);
      if (SUB == ROW_NORM) {
        const float* sc = static_cast<const float*>(m.in[1]) + col;
        va[u] = *reinterpret_cast<const uint4*>(a + row * K + col);
        s0[u] = *reinterpret_cast<const float4*>(sc);
        s1[u] = *reinterpret_cast<const float4*>(sc + 4);
      } else if (SUB == ROW_ACT) {
        va[u] = *reinterpret_cast<const uint4*>(a + row * w_in + col);
        vb[u] = *reinterpret_cast<const uint4*>(a + row * w_in + boff + col);
      } else {
        va[u] = *reinterpret_cast<const uint4*>(a + row * K + col);
        vb[u] = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(m.in[1]) + row * K + col);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * HF_THREADS, r = idx / wv, c = (idx - r * wv) * 8;
      if (idx >= R * wv) continue;
      float f[8], g[8], v[8];
      unpack8(va[u], f);
      if (SUB == ROW_NORM) {
        const float sc[8] = {s0[u].x, s0[u].y, s0[u].z, s0[u].w,
                             s1[u].x, s1[u].y, s1[u].z, s1[u].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) g[j] = sc[j];
      } else {
        unpack8(vb[u], g);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = 0.0f;
        if (ok[u]) {
          if (SUB == ROW_NORM)
            v[j] = f[j] * inv[r] * (1.0f + g[j]);
          else if (SUB == ROW_ACT)
            v[j] = act_apply(act, f[j], act_gated(act) ? g[j] : 0.0f);
          else
            v[j] = f[j] + g[j];
        }
      }
      uint4 o;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      *reinterpret_cast<uint4*>(xs + r * ld + c) = o;
    }
  }
  __syncthreads();
}

// A producer whose rows are the GEMM's rows takes gemm_stage_block; one
// whose output the row stream reshapes (another row width) is produced row
// by row of the GEMM's x (produce_range: a norm reduces each of its own
// rows), inv serving as its scratch.
__device__ __noinline__ void gemm_stage_x(const MemberDesc& m, int r0,
                                          int rows, int R, int kt, int kc0,
                                          int kc1, bf16* xs, int ld,
                                          float* inv) {
  const int sub = m.i[9] - 1;
  if (stage_width(sub, m.i[10], m.i[11]) != m.i[2]) {
    const long long K = m.i[2];
    for (int r = 0; r < rows; ++r)
      produce_range<bf16, GEMM_STAGE_CHUNK>(
          sub, m.i[10], m.f[6], m.in[0], m.in[1], m.i[11], (r0 + r) * K + kc0,
          (r0 + r) * K + kc1, xs + r * ld, inv);
    const int w = kc1 - kc0, wp = (w + kt - 1) / kt * kt;
    for (int idx = threadIdx.x; idx < R * wp; idx += HF_THREADS) {
      const int r = idx / wp, c = idx - r * wp;
      if (r >= rows || c >= w) xs[r * ld + c] = f2bf(0.0f);
    }
    __syncthreads();
    return;
  }
  switch (sub) {
    case ROW_NORM:
      gemm_stage_block<ROW_NORM>(m, r0, rows, R, kt, kc0, kc1, xs, ld, inv);
      break;
    case ROW_ACT:
      gemm_stage_block<ROW_ACT>(m, r0, rows, R, kt, kc0, kc1, xs, ld, inv);
      break;
    default:
      gemm_stage_block<ROW_RESADD>(m, r0, rows, R, kt, kc0, kc1, xs, ld,
                                   inv);
      break;
  }
}

// the global column of column c of a bf16 GEMM tile tn of bn columns, and
// whether it lies inside the weight: a gated tile's first half are gate
// columns tn * bn / 2.. (of F), its second half the up columns F + tn * bn
// / 2..
__device__ __forceinline__ bool gemm_col(bool gated, int N, int bn, int tn,
                                         int c, int* col) {
  const int F = N / 2, h = bn / 2;
  if (!gated) {
    *col = tn * bn + c;
    return *col < N;
  }
  const int j = tn * h + (c < h ? c : c - h);
  *col = c < h ? j : F + j;
  return j < F;
}

// EPI_ADAMW: the block's (mb, bn) tile of the product, rounded as the GEMM
// stores it, is the gradient of elements (m0 + r) * N + col of AdamW's
// (R, 128) view
__device__ __noinline__ void gemm_adamw_tile(const MemberDesc& m,
                                             const float* tile, int m0,
                                             int mb, int tn, int bn) {
  const int N = m.i[3];
  const int cols = min(bn, N - tn * bn);
  const AdamwK k = adamw_consts(m, static_cast<const float*>(m.in[3]));
  bf16* p = static_cast<bf16*>(m.out[0]);
  float* mm = static_cast<float*>(const_cast<void*>(m.in[4]));
  float* vv = static_cast<float*>(const_cast<void*>(m.in[5]));
  for (int idx = threadIdx.x; idx < mb * cols; idx += HF_THREADS) {
    const int r = idx / cols, c = idx - r * cols;
    adamw_elem(k, p, mm, vv, (size_t)(m0 + r) * N + tn * bn + c,
               bf_round(tile[r * bn + c]));
  }
}

// EPI_ROWS: after each of the `tiles` (row block, column tile) pairs stored
// its product into the workspace (out[3]), the last runs the consumer over
// all rows and resets its ticket for the next launch
__device__ __noinline__ void gemm_rows_tail(const MemberDesc& m, int tiles,
                                            float* red) {
  int* tickets = static_cast<int*>(m.out[2]);
  if (!hf_last_of_group(tickets, tiles, tiles)) return;
  if (threadIdx.x == 0) tickets[tiles] = 0;
  consume_range<bf16, GEMM_STAGE_CHUNK>(m, m.i[13], m.i[14], m.f[6],
                                        m.in[3], m.i[15], 0,
                      (long long)m.i[1] * m.i[3],
                      static_cast<const bf16*>(m.out[3]),
                      static_cast<bf16*>(m.out[0]), red);
}

// out(M, N or F) = epilogue(prologue(x)(M, K) @ w(K, N)).  CTA c owns column
// tile c % T (T = ceil(N / GEMM_BN)) of row block (c / T) % B (B = ceil(M /
// (8 NT))) and K slice c / (T B), i[4] rows from i[4] * slice (i[7]
// slices).  The weight (and x, unless a prologue stages it) streams through
// a ring of GEMM_KT-row stages by cp.async; warp w runs mma.sync.m16n8k16
// with the weight's 16 columns 16 w.. on the 16-row side (ldmatrix.trans)
// and the block's 8-row groups on the 8-column side (ldmatrix), over every
// k row of each stage in order.  Every
// stage is applied to all the block's rows, so the weight slice leaves
// memory once a row block.  The tile's last CTA (ticket out[2], reset by
// that CTA) sums the slices' partials (out[1]) in slice order, so every
// element's sum runs in the same order in every launch, whichever tile or
// position holds its column and whatever runs beside it.  One body for the
// member and every chain through it: the chain stages are the calls above;
// CHAINS compiles in the EPI_* epilogues.
template <int NT, bool CHAINS>
__device__ __noinline__ void row_gemm_mma(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = 8 * NT, BN = GEMM_BN, KT = GEMM_KT;
  constexpr int STG = gemm_stages(NT), LDW = GEMM_LDW, LDX = GEMM_LDX;
  static_assert(BN == 16 * HF_WARPS && KT % 32 == 0, "warp and stage layout");
  const int M = m.i[1], K = m.i[2], N = m.i[3], KSL = m.i[4], KS = m.i[7];
  const int act = m.i[5];
  const bf16* x = static_cast<const bf16*>(m.in[0]);
  const bf16* w = static_cast<const bf16*>(m.in[2]);
  bf16* out = static_cast<bf16*>(m.out[0]);
  const bool gated = act_gated(act), staged = m.i[9] != 0;
  const int F = N / 2, ntile = (N + BN - 1) / BN;
  const int nblk = (M + R - 1) / R;
  const int tn = cta % ntile, blk = (cta / ntile) % nblk;
  const int ks = cta / (ntile * nblk);
  const int r0 = blk * R, rows = min(R, M - r0);
  const int k0 = ks * KSL, k1 = min(K, k0 + KSL);
  const int nst = (k1 - k0 + KT - 1) / KT;
  const int sb = gemm_stage_bytes(NT, staged);
  const int xc = gemm_xc(NT), ldxs = xc + 8, xcs = xc / KT;
  bf16* xs = reinterpret_cast<bf16*>(smem + STG * sb);
  float* nred = reinterpret_cast<float*>(smem + STG * sb +
                                         (staged ? R * ldxs * 2 : 0));
  float* tile = reinterpret_cast<float*>(smem);    // after the K loop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage i of the slice: its weight rows (16-byte chunks) and, streamed,
  // x's slice; zeros past k1, N (F) and M.  A thread's weight chunks share
  // one column (rows kw, kw + WRP, ..) and its x chunks one k offset.
  constexpr int CPR = BN / 8, WRP = HF_THREADS / CPR, XCR = KT / 8;
  static_assert(HF_THREADS % CPR == 0 && KT % WRP == 0, "loader layout");
  const int kw = tid / CPR, cw = tid % CPR * 8;
  int wcol;
  const bool wok = gemm_col(gated, N, BN, tn, cw, &wcol);
  const bf16* wsrc = w + wcol;
  const int xr0 = tid / XCR, xo = tid % XCR * 8;
  const bf16* xsrc = x + (size_t)r0 * K + xo;
  auto load = [&](int i) {
    if (i < nst) {
      unsigned char* S = smem + (i % STG) * sb;
      bf16* Ws = reinterpret_cast<bf16*>(S) + kw * LDW + cw;
      const int kb = k0 + i * KT;
#pragma unroll
      for (int u = 0; u < KT / WRP; ++u) {
        const int k = kb + kw + u * WRP;
        const bool ok = wok && k < k1;
        cp_async16(Ws + u * WRP * LDW, ok ? wsrc + (size_t)k * N : w, ok);
      }
      if (!staged) {
        bf16* Xs = reinterpret_cast<bf16*>(S + GEMM_W_BYTES) +
                   xr0 * LDX + xo;
#pragma unroll
        for (int u = 0; u < (R * XCR + HF_THREADS - 1) / HF_THREADS; ++u) {
          const int xr = xr0 + u * (HF_THREADS / XCR);
          if (xr < R) {
            const bool ok = xr < rows && kb + xo < k1;
            cp_async16(Xs + u * (HF_THREADS / XCR) * LDX,
                       ok ? xsrc + (size_t)xr * K + kb : x, ok);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // a prologue's first x chunk (a norm's 1/rms of each row first) before
  // the weight stream: issued after it, its few loads would wait behind the
  // whole stream in the memory system
  if (staged) {
    if (m.i[9] - 1 == ROW_NORM && m.i[11] == K)
      gemm_stage_inv(m, r0, rows, nred);
    gemm_stage_x(m, r0, rows, R, KT, k0, min(k1, k0 + xc), xs, ldxs, nred);
  }
  for (int i = 0; i < STG - 1; ++i) load(i);

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  // an ldmatrix.trans address: lane's k row and column offset in a stage
  const int ar = (lane >> 4) * 8 + (lane & 7), ac = ((lane >> 3) & 1) * 8;

#pragma unroll 1
  for (int i = 0; i < nst; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STG - 2));
    __syncthreads();                // stage i has landed, i - 1 is free
    if (staged && i > 0 && i % xcs == 0) {
      const int kc0 = k0 + i * KT;
      gemm_stage_x(m, r0, rows, R, KT, kc0, min(k1, kc0 + xc), xs, ldxs,
                   nred);
    }
    load(i + STG - 1);
    const unsigned char* S = smem + (i % STG) * sb;
    const bf16* W = reinterpret_cast<const bf16*>(S);
    const bf16* X =
        staged ? xs + (i % xcs) * KT
               : reinterpret_cast<const bf16*>(S + GEMM_W_BYTES);
    const int ldx = staged ? ldxs : LDX;
#pragma unroll
    for (int kp = 0; kp < KT / 32; ++kp) {
      uint32_t a[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm_x4_trans(a[kk], W + (kp * 32 + kk * 16 + ar) * LDW + warp * 16 +
                                 ac);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[4];
        ldsm_x4(b, X + (nt * 8 + (lane & 7)) * ldx + kp * 32 +
                       (lane >> 3) * 8);
        mma_bf16_16816(acc[nt], a[0], b);
        mma_bf16_16816(acc[nt], a[1], b + 2);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // accumulator v of group nt: tile column warp * 16 + lane / 4 (+8 for v
  // >= 2), x row nt * 8 + 2 (lane % 4) + v % 2
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      tile[(nt * 8 + 2 * (lane & 3) + (v & 1)) * BN + warp * 16 +
           (lane >> 2) + (v >> 1) * 8] = acc[nt][v];
  __syncthreads();

  if (KS > 1) {
    // this slice's partial, then the tile's last CTA sums the slices in
    // slice order into the tile
    float* part = static_cast<float*>(m.out[1]);
    int* tickets = static_cast<int*>(m.out[2]);
    const size_t tsz = (size_t)R * BN;
    const size_t sstride = (size_t)nblk * ntile * tsz;
    float* first = part + ((size_t)blk * ntile + tn) * tsz;
    for (int idx = tid; idx < rows * BN; idx += HF_THREADS)
      first[ks * sstride + idx] = tile[idx];
    const int grp = blk * ntile + tn;
    if (!hf_last_of_group(tickets, grp, KS)) return;
    if (tid == 0) tickets[grp] = 0;
    for (int idx = tid; idx < rows * BN; idx += HF_THREADS) {
      float s = __ldcg(first + idx);
      for (int q = 1; q < KS; ++q) s += __ldcg(first + q * sstride + idx);
      tile[idx] = s;
    }
    __syncthreads();
  }

  if (gated) {
    constexpr int H = BN / 2;
    for (int idx = tid; idx < rows * H; idx += HF_THREADS) {
      const int r = idx / H, c = idx % H, j = tn * H + c;
      if (j < F) {
        const float a = bf_round(tile[r * BN + c]);
        const float b = bf_round(tile[r * BN + H + c]);
        out[(size_t)(r0 + r) * F + j] = f2bf(act_apply(act, a, b));
      }
    }
  } else if (CHAINS && m.i[12] == EPI_ADAMW) {
    gemm_adamw_tile(m, tile, r0, rows, tn, BN);
  } else {
    // EPI_ROWS stores the product into its workspace instead of out
    const bf16* res = m.i[8] ? static_cast<const bf16*>(m.in[3]) : nullptr;
    bf16* dst =
        CHAINS && m.i[12] == EPI_ROWS ? static_cast<bf16*>(m.out[3]) : out;
    for (int idx = tid; idx < rows * BN; idx += HF_THREADS) {
      const int r = idx / BN, c = idx % BN, col = tn * BN + c;
      if (col < N) {
        const size_t o = (size_t)(r0 + r) * N + col;
        const float h = tile[idx];
        dst[o] = f2bf(res ? bf_round(h) + bf2f(res[o])
                      : act == ACT_NONE ? h
                                        : act_apply(act, bf_round(h), 0.0f));
      }
    }
  }
  if (CHAINS && m.i[12] == EPI_ROWS) gemm_rows_tail(m, nblk * ntile, nred);
}

template <bool CHAINS>
__device__ __forceinline__ void row_gemm(const MemberDesc& m, int cta) {
  switch (gemm_nt(m.i[1])) {
    case 1: row_gemm_mma<1, CHAINS>(m, cta); break;
    case 2: row_gemm_mma<2, CHAINS>(m, cta); break;
    case 4: row_gemm_mma<4, CHAINS>(m, cta); break;
    default: row_gemm_mma<8, CHAINS>(m, cta); break;
  }
}

// ---------------------------------------------------------------------------
// fp32 GEMM: out(M, N) = x(M, K) @ w(K, N), every operand fp32, split over
// i[7] slices of i[4] K rows (kernels/row.py RowMember.k_slice)
// ---------------------------------------------------------------------------
#define F32_KT 64           // K rows of a ring stage (kernels/row.py F32_KT)
#define F32_RM 8            // x rows a thread accumulates
#define F32_CN 4            // weight columns a thread accumulates
#define F32_RG_MAX 16       // row groups of a pass: at most 128 rows
#define F32_RING_BYTES (64 * 1024)   // the ring's budget
#define F32_XS_BYTES (32 * 1024)     // a staged producer's x chunk budget

// The fp32 GEMM's layout for (M, N), the same for the member and every
// chain through it (the sums' order depends on nothing else):
//   cg   4-column groups of a 64-column tile (16; for N < 64 the power of
//        two that covers N, so that the threads a narrow tile leaves idle
//        take more k residues), tw = 4 cg columns staged a k row;
//   rg   row groups of F32_RM rows: a pass holds mp = 8 rg rows, at most
//        F32_RG_MAX groups, so up to 128 rows share each weight stage;
//   kr   k residues: thread (cg, rg, kr) takes k rows kr, kr + kr_n, ..
//        of each stage (cg x rg x kr <= 256 threads);
//   ldx  the row stride of x staged transposed, [k][ldx], so a thread's 8
//        rows are two float4 reads;
//   stg  ring stages (64 KB, 3..8 stages); xc the columns of a staged
//        producer's x chunk (a multiple of F32_KT, about 32 KB).
struct F32Geo {
  int cg, lcg, tw, rg, mp, kr, ldx, stg, stage_f, ring_f, xc;
};

__host__ __device__ inline F32Geo gemm_f32_geo(int M, int N, bool staged) {
  F32Geo g;
  const int cols = ((N < GEMM_TN ? N : GEMM_TN) + F32_CN - 1) / F32_CN;
  g.cg = 1;
  g.lcg = 0;
  while (g.cg < cols) {
    g.cg *= 2;
    ++g.lcg;
  }
  g.tw = F32_CN * g.cg;
  const int slots = HF_THREADS / g.cg, rows = (M + F32_RM - 1) / F32_RM;
  g.rg = rows < F32_RG_MAX ? rows : F32_RG_MAX;
  if (g.rg > slots) g.rg = slots;
  g.mp = F32_RM * g.rg;
  g.kr = slots / g.rg < F32_KT ? slots / g.rg : F32_KT;
  g.ldx = g.mp + 4;
  g.stage_f = F32_KT * (g.tw + (staged ? 0 : g.ldx));
  const int n = F32_RING_BYTES / (4 * g.stage_f);
  g.stg = n < 3 ? 3 : n > 8 ? 8 : n;
  // after the K loop the ring holds the k residues' sums
  const int red = g.kr * g.mp * g.tw;
  g.ring_f = g.stg * g.stage_f > red ? g.stg * g.stage_f : red;
  const int xst = F32_XS_BYTES / (4 * F32_KT * g.ldx);
  g.xc = staged ? F32_KT * (xst > 1 ? xst : 1) : 0;
  return g;
}

// ring | a staged producer's x chunk [xc][ldx] | a norm's 1/rms per row of
// the pass and HF_WARPS floats of scratch
__host__ __device__ inline int gemm_f32_smem_bytes(const MemberDesc& m) {
  const F32Geo g = gemm_f32_geo(m.i[1], m.i[3], m.i[9] != 0);
  return 4 * (g.ring_f + g.xc * g.ldx + g.mp + HF_WARPS);
}

// cp.async.wait_group with a count known only at run time (the ring's
// depth): at most n groups still pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// STAGED (a row-wise producer's chain, i[9]): columns [kc0, kc1) of the
// pass's x rows m0 .. m0 + mb, each as the producer computes and stores it,
// into xs [k][ld] (transposed; zeros in rows mb .. mp and past kc1 up to a
// whole stage, so every stage reads finite values).  With inv, a norm's 1/rms of
// each of the pass's rows first, one warp a row (rms_inv_warp), into
// nred[0 .. mb); nred[mp ..] is produce_range's scratch.  A norm whose rows
// the row stream reshapes (of another width than K) goes row by row through
// produce_range.  Inlined: as a call inside the K loop it made the body
// spill more and ran the staged chains slower on the H100.
__device__ __forceinline__ void gemm_f32_stage(const MemberDesc& m, int m0,
                                               int mb, int mp, int ld,
                                               int kc0, int kc1, bool inv,
                                               float* xs, float* nred) {
  const long long K = m.i[2];
  const int sub = m.i[9] - 1, act = m.i[10], w_in = m.i[11];
  const int kc = kc1 - kc0, kcp = (kc + F32_KT - 1) / F32_KT * F32_KT;
  if (sub == ROW_NORM && w_in != K) {
    for (int r = 0; r < mb; ++r)
      produce_range<float, NORM_CHUNK, true>(
          sub, act, m.f[6], m.in[0], m.in[1], w_in, (m0 + r) * K + kc0,
          (m0 + r) * K + kc1, xs + r, nred + mp, ld);
    for (int idx = threadIdx.x; idx < mp * kcp; idx += HF_THREADS) {
      const int r = idx / kcp, c = idx - r * kcp;
      if (r >= mb || c >= kc) xs[c * ld + r] = 0.0f;
    }
    __syncthreads();
    return;
  }
  if (sub == ROW_NORM && inv) {
    for (int r = threadIdx.x >> 5; r < mb; r += HF_WARPS) {
      const float v = rms_inv_warp(
          static_cast<const float*>(m.in[0]) + (m0 + r) * K, (int)K, m.f[6]);
      if ((threadIdx.x & 31) == 0) nred[r] = v;
    }
    __syncthreads();
  }
  const int w = stage_width(sub, act, w_in);
  if (w == K && K % 4 == 0) {
    const bool gated = sub == ROW_ACT && act_gated(act);
    // four columns a thread at a time in 16-byte vectors (x's rows are the
    // producer's rows, kc0 and kcp multiples of 4), the arithmetic
    // stage_elem's; a thread's U vectors' loads issued before their stores
    constexpr int U = 4;
    const int q4 = kcp / 4, n = mp * q4;
    for (int i0 = threadIdx.x; i0 < n; i0 += U * HF_THREADS) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = i0 + u * HF_THREADS, r = idx / q4;
        const int c = 4 * (idx - r * q4);
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (idx < n && r < mb && c < kc) {
          const long long row = m0 + r;
          const int col = kc0 + c;
          const float* a = static_cast<const float*>(m.in[0]);
          const float* b = static_cast<const float*>(m.in[1]);
          if (sub == ROW_NORM) {
            const float4 xv = *reinterpret_cast<const float4*>(a + row * K +
                                                               col);
            const float4 sv = *reinterpret_cast<const float4*>(b + col);
            const float inv = nred[r];
            v[u] = make_float4(xv.x * inv * (1.0f + sv.x),
                               xv.y * inv * (1.0f + sv.y),
                               xv.z * inv * (1.0f + sv.z),
                               xv.w * inv * (1.0f + sv.w));
          } else if (sub == ROW_ACT) {
            const float* h = a + row * w_in;
            const float4 av = *reinterpret_cast<const float4*>(h + col);
            const float4 bv =
                gated ? *reinterpret_cast<const float4*>(h + w + col)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            v[u] = make_float4(act_apply(act, av.x, bv.x),
                               act_apply(act, av.y, bv.y),
                               act_apply(act, av.z, bv.z),
                               act_apply(act, av.w, bv.w));
          } else {
            const float4 av =
                *reinterpret_cast<const float4*>(a + row * K + col);
            const float4 bv =
                *reinterpret_cast<const float4*>(b + row * K + col);
            v[u] = make_float4(av.x + bv.x, av.y + bv.y, av.z + bv.z,
                               av.w + bv.w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = i0 + u * HF_THREADS, r = idx / q4;
        if (idx < n) {
          float* d = xs + 4 * (idx - r * q4) * ld + r;
          d[0] = v[u].x;
          d[ld] = v[u].y;
          d[2 * ld] = v[u].z;
          d[3 * ld] = v[u].w;
        }
      }
    }
    __syncthreads();
    return;
  }
  // element by element (x's rows reshaped from the producer's, or K % 4):
  // four elements' loads issued before their stores: through generic
  // pointers the compiler must assume a store to xs may feed a later load
  constexpr int U = 4;
  const int n = mp * kcp;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * HF_THREADS) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * HF_THREADS, r = idx / kcp, c = idx - r * kcp;
      v[u] = 0.0f;
      if (idx < n && r < mb && c < kc) {
        // the producer's (row, column) of x's element (m0 + r, kc0 + c)
        long long pr = m0 + r;
        int pc = kc0 + c;
        if (w != K) {
          const long long f = pr * K + pc;
          pr = f / w;
          pc = (int)(f % w);
        }
        v[u] = sub == ROW_NORM
                   ? stage_elem<float, ROW_NORM>(act, m.in[0], m.in[1], w_in,
                                                 w, pr, pc, nred[r])
               : sub == ROW_ACT
                   ? stage_elem<float, ROW_ACT>(act, m.in[0], m.in[1], w_in,
                                                w, pr, pc, 0.0f)
                   : stage_elem<float, ROW_RESADD>(act, m.in[0], m.in[1],
                                                   w_in, w, pr, pc, 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * HF_THREADS, r = idx / kcp;
      if (idx < n) xs[(idx - r * kcp) * ld + r] = v[u];
    }
  }
  __syncthreads();
}

// the GEMM's product s of element (r, col) through its epilogue: the
// residual add (i[8]), the AdamW update (EPI_ADAMW), the workspace of a row
// consumer (EPI_ROWS, out[3]) or the store
__device__ __forceinline__ void gemm_f32_out(const MemberDesc& m, int r,
                                             int col, float s) {
  const size_t e = (size_t)r * m.i[3] + col;
  if (m.i[8]) s += static_cast<const float*>(m.in[3])[e];
  if (m.i[12] == EPI_ADAMW)
    adamw_elem(adamw_consts(m, static_cast<const float*>(m.in[3])),
               static_cast<float*>(m.out[0]),
               static_cast<float*>(const_cast<void*>(m.in[4])),
               static_cast<float*>(const_cast<void*>(m.in[5])), e, s);
  else
    static_cast<float*>(m.i[12] == EPI_ROWS ? m.out[3] : m.out[0])[e] = s;
}

// CTA c owns column tile c % T (T = ceil(N / GEMM_TN)) and K slice c / T.
// For each pass of up to mp rows the weight slice streams once through a
// ring of F32_KT-row stages by cp.async (16-byte copies; x, unless a
// producer stages it, beside it in 4-byte copies landing transposed), and
// each stage is applied to every row of the pass before it is released:
// thread (cg, rg, kr) accumulates rows 8 rg .. + 7 x columns 4 cg .. + 3
// over its k residue, a float4 of w and two of x for 32 FMAs (8 x 8 a
// thread, and 4-row k quads over x staged row-major, spilled inside the
// 128-register bundle kernel and ran the 8-row GEMMs slower on the H100).
// The k residues' sums are added in residue order; a split K writes the
// slice's partial (out[1], (KS, M, N)) and the tile's last CTA (ticket
// out[2], which it resets) sums the slices in slice order, 8 loads in
// flight at a time.  So each element's sum runs in one order in every
// launch and in every chain through the GEMM.  Not inlined: inlined, its
// bookkeeping made ptxas spill inside the 128-register bundle kernel.
// STAGED: a row-wise producer stages x (i[9]).  The chain epilogues run
// where the sum is done (gemm_f32_out); EPI_ROWS's last tile then runs the
// consumer over the whole product (ticket out[2][T], reset by that CTA).
template <bool STAGED>
__device__ __noinline__ void row_gemm_f32(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = m.i[1], K = m.i[2], N = m.i[3], KSL = m.i[4], KS = m.i[7];
  const F32Geo G = gemm_f32_geo(M, N, STAGED);
  const float* x = static_cast<const float*>(m.in[0]);
  const float* w = static_cast<const float*>(m.in[2]);
  float* ws = static_cast<float*>(m.out[1]);
  int* tickets = static_cast<int*>(m.out[2]);
  float* ring = reinterpret_cast<float*>(smem);
  float* xs = ring + G.ring_f;                 // STAGED: x's chunk
  float* nred = xs + G.xc * G.ldx;

  const int ntile = (N + GEMM_TN - 1) / GEMM_TN;
  const int tile = cta % ntile, ks = cta / ntile;
  const int k0 = ks * KSL, k1 = min(K, k0 + KSL);
  const int nst = (k1 - k0 + F32_KT - 1) / F32_KT, xcs = G.xc / F32_KT;
  const int c0 = tile * GEMM_TN;
  const int tid = threadIdx.x, cg = tid & (G.cg - 1), o = tid >> G.lcg;
  const int rg = o % G.rg, kr = o / G.rg;

  for (int m0 = 0; m0 < M; m0 += G.mp) {
    const int mb = min(G.mp, M - m0);
    // stage i into ring slot `slot`: the weight's rows k0 + 64 i.., the
    // tile's tw columns, zeros past k1 and N; streamed x rows m0..
    // likewise, zeros past mb and k1
    auto load = [&](int i, int slot) {
      if (i < nst) {
        float* S = ring + slot * G.stage_f;
        const int kb = k0 + i * F32_KT;
        for (int c = tid; c < F32_KT * G.cg; c += HF_THREADS) {
          const int kk = c >> G.lcg, cc = 4 * (c & (G.cg - 1));
          const bool ok = kb + kk < k1 && c0 + cc < N;
          cp_async16(S + kk * G.tw + cc,
                     ok ? w + (size_t)(kb + kk) * N + c0 + cc : w, ok);
        }
        if (!STAGED) {
          float* X = S + F32_KT * G.tw;
          for (int e = tid; e < F32_KT * G.mp; e += HF_THREADS) {
            const int r = e / F32_KT, kk = e % F32_KT;
            const bool ok = r < mb && kb + kk < k1;
            cp_async4(X + kk * G.ldx + r,
                      ok ? x + (size_t)(m0 + r) * K + kb + kk : x, ok);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    // a producer's first x chunk (a norm's 1/rms first) before the stream
    if (STAGED)
      gemm_f32_stage(m, m0, mb, G.mp, G.ldx, k0, min(k1, k0 + G.xc), true,
                     xs, nred);
    for (int i = 0; i < G.stg - 1; ++i) load(i, i);

    float acc[F32_RM][F32_CN];
#pragma unroll
    for (int r = 0; r < F32_RM; ++r)
#pragma unroll
      for (int c = 0; c < F32_CN; ++c) acc[r][c] = 0.0f;
    int rd = 0, wr = G.stg - 1, xo = 0;   // ring slots read / loaded, x chunk
#pragma unroll 1
    for (int i = 0; i < nst; ++i) {
      cp_async_wait(G.stg - 2);
      __syncthreads();                // stage i has landed, i - 1 is free
      if (STAGED && i > 0 && xo == xcs) {
        const int kc0 = k0 + i * F32_KT;
        gemm_f32_stage(m, m0, mb, G.mp, G.ldx, kc0, min(k1, kc0 + G.xc),
                       false, xs, nred);
        xo = 0;
      }
      load(i + G.stg - 1, wr);
      wr = wr + 1 == G.stg ? 0 : wr + 1;
      const float* W = ring + rd * G.stage_f + 4 * cg;
      const float* X = (STAGED ? xs + xo * F32_KT * G.ldx
                               : ring + rd * G.stage_f + F32_KT * G.tw) +
                       F32_RM * rg;
      rd = rd + 1 == G.stg ? 0 : rd + 1;
      ++xo;
      if (kr < G.kr) {
#pragma unroll 2
        for (int kk = kr; kk < F32_KT; kk += G.kr) {
          const float4 wa = *reinterpret_cast<const float4*>(W + kk * G.tw);
          const float4 xa = *reinterpret_cast<const float4*>(X + kk * G.ldx);
          const float4 xb =
              *reinterpret_cast<const float4*>(X + kk * G.ldx + 4);
          const float xv[F32_RM] = {xa.x, xa.y, xa.z, xa.w,
                                    xb.x, xb.y, xb.z, xb.w};
          const float wv[F32_CN] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
          for (int r = 0; r < F32_RM; ++r)
#pragma unroll
            for (int c = 0; c < F32_CN; ++c)
              acc[r][c] = fmaf(xv[r], wv[c], acc[r][c]);
        }
      }
    }
    cp_async_wait(0);
    __syncthreads();

    // the k residues' sums through the ring, added in residue order
    if (kr < G.kr) {
#pragma unroll
      for (int r = 0; r < F32_RM; ++r) {
        *reinterpret_cast<float4*>(
            ring + (kr * G.mp + F32_RM * rg + r) * G.tw + 4 * cg) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < mb * G.tw; idx += HF_THREADS) {
      const int r = idx / G.tw, col = c0 + idx - r * G.tw;
      if (col >= N) continue;
      float s = ring[idx];
      for (int q = 1; q < G.kr; ++q) s += ring[q * G.mp * G.tw + idx];
      if (KS > 1)
        ws[((size_t)ks * M + m0 + r) * N + col] = s;
      else
        gemm_f32_out(m, m0 + r, col, s);
    }
    __syncthreads();                  // the ring is loaded again next pass
  }

  if (KS > 1) {
    // the tile's last CTA sums the K slices in slice order
    if (!hf_last_of_group(tickets, tile, KS)) return;
    if (tid == 0) tickets[tile] = 0;
    const size_t step = (size_t)M * N;
    for (int idx = tid; idx < M * G.tw; idx += HF_THREADS) {
      const int r = idx / G.tw, col = c0 + idx - r * G.tw;
      if (col >= N) continue;
      const float* p = ws + (size_t)r * N + col;
      float s = __ldcg(p);
      int q = 1;
      for (; q + 8 <= KS; q += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(p + (q + u) * step);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      for (; q < KS; ++q) s += __ldcg(p + q * step);
      gemm_f32_out(m, r, col, s);
    }
  }
  if (m.i[12] != EPI_ROWS) return;
  // the last tile to finish runs the consumer over the whole product
  if (!hf_last_of_group(tickets, ntile, ntile)) return;
  if (tid == 0) tickets[ntile] = 0;
  consume_range<float>(m, m.i[13], m.i[14], m.f[6], m.in[3], m.i[15], 0,
                       (long long)M * N, static_cast<const float*>(m.out[3]),
                       static_cast<float*>(m.out[0]), nred + G.mp);
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

// standalone residual add: out = h + res over (M, F), in fp32, stored as T;
// CTA c owns elements [c * CH, (c + 1) * CH), CH = HF_THREADS * RESADD_VECS
// 16-byte vectors.  Not inlined, like row_norm below: inlined, the
// residual add and the fp32 norm moved ptxas's allocation of the whole
// bundle kernel and slowed the grouped expert FFN member by 5% on the
// H100; as calls the kernel keeps the allocation it had without them.
// It runs at torch.add's DRAM rate on the H100 (within 1%); a narrow
// bundle instance at 4 CTAs an SM (the row family's holds 2), fewer CTAs
// looping over the chunks, other chunk sizes and evict-first or evict-last
// hints were no faster (PERF.md).
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

// RMSNorm alone: CTA c owns rows c * i[4] .. (i[4] rows a CTA, one a warp:
// kernels/row.py norm_rows), the order above.  A row of at most NORM_VECS
// vectors a lane leaves memory once: the lane's vectors all loaded before
// the first is used, summed, then scaled from the same registers and
// stored as 16-byte vectors, (1 + scale) read as 16-byte vectors beside
// them.  A wider row reads x again after its 1/rms; a row that is not
// 16-byte aligned goes element by element.  At one row a CTA (decode) the
// lane also prefetches (1 + scale) into L1 while x is in flight, so the
// scale pass waits on L1, not on device memory; with more rows a CTA the
// scale is in L1 already and the prefetches only cost issue slots (at
// 8192 rows they made the member slower on the H100).  Not inlined, for
// either type: inlined, a row body moved ptxas's allocation of the whole
// bundle kernel (PERF.md).
template <typename T>
__device__ __noinline__ void row_norm(const MemberDesc& m, int cta) {
  constexpr int V = norm_v<T>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = m.i[2];
  const long long r = (long long)cta * m.i[4] + warp;
  if (warp >= m.i[4] || r >= m.i[1]) return;
  const T* x = static_cast<const T*>(m.in[0]) + r * d;
  const float* scale = static_cast<const float*>(m.in[1]);
  T* y = static_cast<T*>(m.out[0]) + r * d;
  const float eps = m.f[0];
  const bool vec = aligned16(x) && aligned16(y) && aligned16(scale);
  const int nv = vec ? d / V : 0;       // the whole vectors taken as such
  float inv;
  if (vec && nv <= 32 * NORM_VECS) {
    uint4 v[NORM_VECS];
    norm_load<T, NORM_VECS>(x, 0, nv, v);
    if (m.i[4] == 1) norm_prefetch(scale, d, lane, 32);
    inv = norm_inv(norm_sumsq_rest(x, d, true,
                                   norm_sumsq<T, NORM_VECS>(v, 0, nv, 0.0f)),
                   d, eps);
#pragma unroll
    for (int u = 0; u < NORM_VECS; ++u) {
      const int j = lane + 32 * u;
      if (j < nv) norm_store16(v[u], scale + j * V, inv, y + j * V);
    }
  } else {
    if (m.i[4] == 1) norm_prefetch(scale, d, lane, 32);
    inv = rms_inv_warp(x, d, eps);
    for (int j = lane; j < nv; j += 32)
      norm_store16(reinterpret_cast<const uint4*>(x)[j], scale + j * V, inv,
                   y + j * V);
  }
  for (int k = nv * V + lane; k < d; k += 32)
    y[k] = from_f32<T>(to_f32(x[k]) * inv * (1.0f + scale[k]));
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
        row_norm<float>(m, cta);
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
    case ROW_NORM: return 0;
    case ROW_GEMM: return m.i[6] ? gemm_f32_smem_bytes(m)
                                 : gemm_smem_bytes(m);
    case ROW_CHAIN:
      return hf_align16(m.i[1] * (m.i[6] ? 4 : 2)) + HF_WARPS * 4;
    default: return 0;   // activation, residual add
  }
}
