// Paper suite members: the nine Fig. 8 kernel analogues on seven bodies
// (maxpool, upsample, bnstats, im2col, hist, ethash_like, hash_like; sha,
// blake and blake2b are hash_like with 16, 24 and 20 rounds).
//
// Replaces the TPU kernels src/repro/kernels/paper_suite.py:49 (maxpool),
// :67 (upsample), :86 (bnstats), :108 (im2col), :159 (hist), :129
// (ethash_like) and :186 (_make_hash_like, reached through :213-223).  Each
// member computes its TPU kernel's function, not a block-by-block copy.
//
// CTA geometry is the card's, not the reference's grid (the planner still
// plans on the grid).  The streaming bodies take 16 CTAs per TPU grid step
// where the block divides (descriptor i[3] rows per CTA), so the planner's
// ratios keep their proportions when bundle.cu applies them to CTAs:
// maxpool 512 CTAs of 16 rows, upsample 256 of 16, im2col 256 of 16, hist
// 512 of 4, bnstats 512 of (128 rows x 128 columns), hash_like 128 of 32
// rows.  ethash_like departs: 16 slices of 32 output rows x 8 runs of 16 DAG
// blocks = 128 CTAs (one per grid step), which keeps its partials at 2 MB.
//
// Bounds on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32): maxpool,
// upsample, im2col, bnstats and hist by bytes; ethash_like (34 MB and 2.17
// GFLOP at the defaults) and hash_like by fp32 operations.  The streaming
// bodies move 16-byte vectors; ethash_like keeps w (64 KB) and a 32 x 128
// fp32 tile in shared memory, each thread owns a 4 x 4 output block and
// walks k in order; hash_like keeps w in registers and the state in shared
// memory (see its body).  Both use explicit fmaf (the build uses -fmad=false,
// so nothing else is contracted).  tanh is tanhf.
//
// Carries.  bnstats, hist and ethash_like accumulate across TPU grid steps.
// Here every CTA writes a partial into a workspace its member owns (the
// wrapper allocates it per launch, the tickets zeroed), calls
// __threadfence(), and takes an atomic ticket of its group; the CTA that draws
// the group's last ticket sums the group's partials in CTA order, writes the
// output and resets the ticket.  No CTA waits for another, so a launch with
// more CTAs than fit on the card cannot deadlock, and no float atomic touches
// an output, so the result is the same whatever order the CTAs run in: a
// fused launch is bitwise equal to the member launched alone.  hist's
// partials are integer counts, summed with integer atomics (exact in any
// order).
//
// Descriptor: i[0] = R (input rows; the DAG's for ethash_like), i[1] = C,
// i[2] = dtype (0 bf16, 1 fp32), i[3] = rows per CTA, then per body:
//   im2col   i[4] = K
//   bnstats  i[4] = row chunks (CTAs per 128-column slice)
//   hist     i[4] = bins, f[0] = bins / 8
//   ethash   i[4] = seed rows (bm), i[5] = runs per slice
//   hash     i[4] = rounds
// in = the op's inputs; out[0] = the output; out[1] = workspace (partials,
// or hist's counts), out[2] = tickets (int, zeroed).
#pragma once

#include "common.cuh"

#define PS_TILE_C 128      // matmul bodies: columns (= the reference's LANES)
#define PS_TILE_R 32       // matmul bodies: rows of a tile
#define PS_SLICE_C 128     // bnstats: columns per CTA
#define PS_UNROLL 4        // streaming bodies: 16-byte loads in flight per thread

// ---------------------------------------------------------------------------
// maxpool: (R, C) -> (R/2, C), the max of each row pair
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 ps_max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

__device__ __forceinline__ uint4 ps_max8(uint4 a, uint4 b) {
  const bf16* x = reinterpret_cast<const bf16*>(&a);
  const bf16* y = reinterpret_cast<const bf16*>(&b);
  uint4 r;
  bf16* o = reinterpret_cast<bf16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = bf2f(x[j]) >= bf2f(y[j]) ? x[j] : y[j];
  return r;
}

__device__ void maxpool_member(const MemberDesc& m, int cta) {
  const int C = m.i[1], rows = m.i[3];
  const int cv = C * (m.i[2] ? 4 : 2) / 16;     // 16-byte vectors per row
  const uint4* x = static_cast<const uint4*>(m.in[0]) + (size_t)cta * rows * cv;
  uint4* out = static_cast<uint4*>(m.out[0]) + (size_t)cta * rows / 2 * cv;
  const int n = rows / 2 * cv;
  for (int v0 = threadIdx.x; v0 < n; v0 += PS_UNROLL * HF_THREADS) {
    uint4 a[PS_UNROLL], b[PS_UNROLL];           // all loads first
#pragma unroll
    for (int u = 0; u < PS_UNROLL; ++u) {
      const int v = v0 + u * HF_THREADS;
      if (v < n) {
        const int r = v / cv, c = v % cv;
        a[u] = x[(2 * r) * cv + c];
        b[u] = x[(2 * r + 1) * cv + c];
      }
    }
#pragma unroll
    for (int u = 0; u < PS_UNROLL; ++u) {
      const int v = v0 + u * HF_THREADS;
      if (v >= n) break;
      uint4 o;
      if (m.i[2]) {
        const float4 y = ps_max4(*reinterpret_cast<const float4*>(&a[u]),
                                 *reinterpret_cast<const float4*>(&b[u]));
        o = *reinterpret_cast<const uint4*>(&y);
      } else {
        o = ps_max8(a[u], b[u]);
      }
      out[v] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// upsample: (R, C) -> (2R, C), every row twice
// ---------------------------------------------------------------------------
__device__ void upsample_member(const MemberDesc& m, int cta) {
  const int C = m.i[1], rows = m.i[3];
  const int cv = C * (m.i[2] ? 4 : 2) / 16;
  const uint4* x = static_cast<const uint4*>(m.in[0]) + (size_t)cta * rows * cv;
  uint4* out = static_cast<uint4*>(m.out[0]) + (size_t)cta * 2 * rows * cv;
  const int n = rows * cv;
  for (int v0 = threadIdx.x; v0 < n; v0 += PS_UNROLL * HF_THREADS) {
    uint4 a[PS_UNROLL];
#pragma unroll
    for (int u = 0; u < PS_UNROLL; ++u) {
      const int v = v0 + u * HF_THREADS;
      if (v < n) a[u] = x[v];
    }
#pragma unroll
    for (int u = 0; u < PS_UNROLL; ++u) {
      const int v = v0 + u * HF_THREADS;
      if (v >= n) break;
      const int r = v / cv, c = v % cv;
      out[(2 * r) * cv + c] = a[u];
      out[(2 * r + 1) * cv + c] = a[u];
    }
  }
}

// ---------------------------------------------------------------------------
// im2col: (R, C) -> (R, K*C), block k of a row is the row rotated left by k
// ---------------------------------------------------------------------------
template <typename T>
__device__ void im2col_rows(const MemberDesc& m, int cta) {
  constexpr int VEC = 16 / sizeof(T);
  const int C = m.i[1], rows = m.i[3], K = m.i[4];
  const T* x = static_cast<const T*>(m.in[0]);
  T* out = static_cast<T*>(m.out[0]);
  const size_t r0 = (size_t)cta * rows;
  const int ov = K * C / VEC;                  // output vectors per row
  for (int v = threadIdx.x; v < rows * ov; v += HF_THREADS) {
    const int r = v / ov, e = (v % ov) * VEC;
    const int k = e / C, c = e % C;
    const T* row = x + (r0 + r) * C;
    uint4 o;
    T* ot = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int src = c + k + j;                 // < 2C: one wrap at most
      ot[j] = row[src < C ? src : src - C];
    }
    *reinterpret_cast<uint4*>(out + (r0 + r) * K * C + e) = o;
  }
}

__device__ void im2col_member(const MemberDesc& m, int cta) {
  if (m.i[2]) im2col_rows<float>(m, cta); else im2col_rows<bf16>(m, cta);
}

// ---------------------------------------------------------------------------
// bnstats: (R, C) -> (2, C) fp32 column sums of x and x*x.  CTA = (row chunk,
// 128-column slice), local = chunk * n_slices + slice; a lane owns 4
// columns, a warp every 8th row; the 8 warps' sums are added in warp order,
// the chunks' partials in chunk order by the slice's last CTA.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ps_ld4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void ps_ld4(const bf16* p, float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

template <typename T>
__device__ void bnstats_cta(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);   // [HF_WARPS][2][128]
  const int C = m.i[1], rows = m.i[3], chunks = m.i[4];
  const int n_sl = C / PS_SLICE_C;
  const int slice = cta % n_sl, chunk = cta / n_sl;
  const T* x = static_cast<const T*>(m.in[0]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = slice * PS_SLICE_C + lane * 4;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int r = warp; r < rows; r += HF_WARPS) {
    float v[4];
    ps_ld4(x + ((size_t)chunk * rows + r) * C + c0, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] += v[j];
      q[j] += v[j] * v[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[(warp * 2 + 0) * PS_SLICE_C + lane * 4 + j] = s[j];
    red[(warp * 2 + 1) * PS_SLICE_C + lane * 4 + j] = q[j];
  }
  __syncthreads();
  // thread t -> (stat t / 128, column t % 128) of this slice
  const int st = threadIdx.x / PS_SLICE_C, col = threadIdx.x % PS_SLICE_C;
  float acc = 0.f;
  for (int w = 0; w < HF_WARPS; ++w) acc += red[(w * 2 + st) * PS_SLICE_C + col];
  float* part = static_cast<float*>(m.out[1]);   // [cta][2][128]
  part[(size_t)cta * 2 * PS_SLICE_C + threadIdx.x] = acc;
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), slice, chunks)) return;
  float tot = 0.f;
#pragma unroll 8
  for (int k = 0; k < chunks; ++k)
    tot += __ldcg(part + ((size_t)k * n_sl + slice) * 2 * PS_SLICE_C + threadIdx.x);
  static_cast<float*>(m.out[0])[st * C + slice * PS_SLICE_C + col] = tot;
  if (threadIdx.x == 0) static_cast<int*>(m.out[2])[slice] = 0;
}

__device__ void bnstats_member(const MemberDesc& m, int cta) {
  if (m.i[2]) bnstats_cta<float>(m, cta); else bnstats_cta<bf16>(m, cta);
}

// ---------------------------------------------------------------------------
// hist: (R, C) fp32 -> (1, bins) fp32 counts of trunc(clip((x+4)*bins/8,
// 0, bins-1)), the reference's binning in fp32.  A CTA counts its rows in
// shared memory, adds its counts to the int workspace, and the last CTA
// writes them out as floats.
// ---------------------------------------------------------------------------
__device__ void hist_member(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cnt = reinterpret_cast<int*>(smem);
  const int C = m.i[1], rows = m.i[3], bins = m.i[4];
  const float scale = m.f[0], top = (float)(bins - 1);
  for (int b = threadIdx.x; b < bins; b += HF_THREADS) cnt[b] = 0;
  __syncthreads();
  const float4* x = static_cast<const float4*>(m.in[0]) + (size_t)cta * rows * C / 4;
  for (int v = threadIdx.x; v < rows * C / 4; v += HF_THREADS) {
    const float4 a = x[v];
    const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = __fmul_rn(__fadd_rn(e[j], 4.0f), scale);
      atomicAdd(cnt + (int)fminf(fmaxf(t, 0.0f), top), 1);
    }
  }
  __syncthreads();
  int* tot = static_cast<int*>(m.out[1]);
  for (int b = threadIdx.x; b < bins; b += HF_THREADS)
    if (cnt[b]) atomicAdd(tot + b, cnt[b]);
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), 0, m.ctas)) return;
  float* out = static_cast<float*>(m.out[0]);
  for (int b = threadIdx.x; b < bins; b += HF_THREADS) {
    out[b] = (float)__ldcg(tot + b);
    tot[b] = 0;
  }
  if (threadIdx.x == 0) static_cast<int*>(m.out[2])[0] = 0;
}

// ---------------------------------------------------------------------------
// The matmul tile: acc (4 x 4 per thread) = A (32 x 128, shared) @ W (128 x
// 128, shared), k in order.  Warp w owns rows 4w..4w+3, lane l columns
// 4l..4l+3: the A reads are broadcasts, the W reads one 512-byte row.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ps_tile_matmul(const float* A, const float* W,
                                               float acc[4][4]) {
  const int r0 = (threadIdx.x >> 5) * 4, c0 = (threadIdx.x & 31) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < PS_TILE_C; k += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(A + (r0 + i) * PS_TILE_C + k);
      a[i][0] = t.x; a[i][1] = t.y; a[i][2] = t.z; a[i][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 t = *reinterpret_cast<const float4*>(W + (k + kk) * PS_TILE_C + c0);
      b[kk][0] = t.x; b[kk][1] = t.y; b[kk][2] = t.z; b[kk][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
  }
}

// copy a (rows x 128) fp32 matrix from device memory into shared memory
__device__ __forceinline__ void ps_load_rows(float* dst, const float* src,
                                             int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int v = threadIdx.x; v < rows * PS_TILE_C / 4; v += HF_THREADS) d[v] = s[v];
}

// ---------------------------------------------------------------------------
// hash_like: (R, 128) fp32, `rounds` x s = tanh(s @ w).  A CTA owns 32 rows for
// all rounds; the state S stays in shared memory between rounds and w stays in
// registers, 64 a lane, loaded once a CTA (w is L2-resident after the first
// CTAs), so the loop reads no w from shared memory.  The k rows are cut into G
// = 128 / KG groups of KG; warp w is k group g = w / (8 / G) and lane l of its
// column group owns NC = 64 / KG adjacent columns.  For HS_RG rows at a time
// the lane reads S[r, g KG + k] as broadcast 16-byte loads (every lane of the
// warp the same address: one wavefront) and sums its NC columns over its KG k
// in k order (fmaf from 0): HS_RG x NC independent chains.  The groups'
// partials go to shared memory ([G][RS][128] fp32, 64 KB at RS = 128 / G rows a
// step, so the member keeps the 80 KB a CTA of ethash_like), and the 256
// threads add each output's G partials in group order, apply tanhf and write S:
// two barriers a step, 32 / RS steps a round.  The member runs KG = 32
// (quarters: 2 columns a lane, all 32 rows in one step) and HS_RG = 8.  On the
// H100 the loop alone reaches about 55% of the fp32 FMA rate and the combine,
// tanhf and barriers add a fifth (scripts/member_variants.py: loop_only,
// no_combine, no_tanh); 16-deep groups (half the state bytes a fmaf) and 4 rows
// at once were slower, and two hash CTAs on one SM (a fused hash pair) run no
// faster than in turn, so a rate of the SM, not the latency of one CTA's 8
// warps, holds it there (PERF.md).  Each output's order is fixed, so a fused
// launch is bitwise equal to the member alone.  Not inlined, so the bundle
// instances keep the allocation they have without it; w's 64 registers, the
// HS_RG x NC sums and their HS_RG x 4 state values fit the 128 that
// __launch_bounds__(256, 2) leaves, unspilled.
// ---------------------------------------------------------------------------
#define HS_KG 32           // k rows of a lane's slice of w (the member's KG)
#define HS_RG 8            // rows a lane sums at once (HS_RG x NC fmaf chains)

// NC adjacent floats (2 or 4, 8- or 16-byte aligned) as one access
template <int NC>
__device__ __forceinline__ void ps_load_nc(const float* p, float* v) {
  if constexpr (NC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  }
}
template <int NC>
__device__ __forceinline__ void ps_store_nc(float* p, const float* v) {
  if constexpr (NC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int KG>
__device__ __forceinline__ void hash_rounds(const MemberDesc& m, int cta) {
  constexpr int G = PS_TILE_C / KG;      // k groups
  constexpr int NC = 64 / KG;            // columns a lane
  constexpr int CG = HF_WARPS / G;       // column groups (warps a k group)
  constexpr int RS = 128 / G;            // rows a step (partials: 64 KB)
  constexpr int RV = RS * PS_TILE_C / 4; // 16-byte vectors of a step's rows
  static_assert(CG * 32 * NC == PS_TILE_C && PS_TILE_R % RS == 0 &&
                RV % HF_THREADS == 0, "hash geometry");
  extern __shared__ __align__(16) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);              // [G][RS][128]
  float* S = P + G * RS * PS_TILE_C;                      // [32][128]
  const int rounds = m.i[4];
  const size_t row0 = (size_t)cta * PS_TILE_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / CG, c = (warp % CG) * 32 * NC + NC * lane;
  const float* w = static_cast<const float*>(m.in[1]) +
                   (size_t)g * KG * PS_TILE_C + c;
  float wr[KG][NC];
#pragma unroll
  for (int k = 0; k < KG; ++k) ps_load_nc<NC>(w + k * PS_TILE_C, wr[k]);
  ps_load_rows(S, static_cast<const float*>(m.in[0]) + row0 * PS_TILE_C,
               PS_TILE_R);
  __syncthreads();
  const float* Sg = S + g * KG;
  float* Pg = P + g * RS * PS_TILE_C + c;
  for (int round = 0; round < rounds; ++round) {
    for (int r0 = 0; r0 < PS_TILE_R; r0 += RS) {
      for (int rg = 0; rg < RS; rg += HS_RG) {
        float acc[HS_RG][NC];
#pragma unroll
        for (int i = 0; i < HS_RG; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
#pragma unroll
        for (int k = 0; k < KG; k += 4) {
          float4 sv[HS_RG];
#pragma unroll
          for (int i = 0; i < HS_RG; ++i)
            sv[i] = *reinterpret_cast<const float4*>(
                Sg + (r0 + rg + i) * PS_TILE_C + k);
#pragma unroll
          for (int i = 0; i < HS_RG; ++i) {
            const float e[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int j = 0; j < NC; ++j)
                acc[i][j] = fmaf(e[kk], wr[k + kk][j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < HS_RG; ++i)
          ps_store_nc<NC>(Pg + (rg + i) * PS_TILE_C, acc[i]);
      }
      __syncthreads();
      // the step's rows: each output's G partials in group order, tanhf
      const float4* P4 = reinterpret_cast<const float4*>(P);
#pragma unroll
      for (int u = 0; u < RV / HF_THREADS; ++u) {
        const int v = threadIdx.x + u * HF_THREADS;
        float4 a = P4[v];
#pragma unroll
        for (int gg = 1; gg < G; ++gg) {
          const float4 b = P4[gg * RV + v];
          a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
        }
        reinterpret_cast<float4*>(S + r0 * PS_TILE_C)[v] =
            make_float4(tanhf(a.x), tanhf(a.y), tanhf(a.z), tanhf(a.w));
      }
      __syncthreads();
    }
  }
  float* out = static_cast<float*>(m.out[0]) + row0 * PS_TILE_C;
  ps_load_rows(out, S, PS_TILE_R);   // shared -> device (same copy loop)
}

__device__ __noinline__ void hash_member(const MemberDesc& m, int cta) {
  hash_rounds<HS_KG>(m, cta);
}

// ---------------------------------------------------------------------------
// ethash_like: out (bm, 128) = sum over DAG blocks s of tanh((x + dag_s) @ w).
// CTA local = run * n_slices + slice owns output rows [32 slice, +32) over
// the run's DAG blocks, in order; the next block's rows are loaded into
// registers while this block's product runs.  The slice's last CTA adds the
// runs' partials in run order.
// ---------------------------------------------------------------------------
__device__ void ethash_member(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* W = reinterpret_cast<float*>(smem);
  float* A = W + PS_TILE_C * PS_TILE_C;
  const int R = m.i[0], bm = m.i[4], runs = m.i[5];
  const int n_sl = bm / PS_TILE_R, per_run = R / bm / runs;
  const int slice = cta % n_sl, run = cta / n_sl;
  const float4* dag = static_cast<const float4*>(m.in[0]);
  const float4* xs = static_cast<const float4*>(m.in[1]);
  constexpr int NV = PS_TILE_R * PS_TILE_C / 4 / HF_THREADS;   // 4 vectors
  constexpr int RV = PS_TILE_C / 4;                            // per row
  const size_t base = (size_t)slice * PS_TILE_R * RV;          // in a block
  float4 x[NV], d[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    x[j] = xs[base + threadIdx.x + j * HF_THREADS];
    d[j] = dag[(size_t)run * per_run * bm * RV + base + threadIdx.x + j * HF_THREADS];
  }
  ps_load_rows(W, static_cast<const float*>(m.in[2]), PS_TILE_C);
  float tot[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = 0.f;
  for (int b = 0; b < per_run; ++b) {
    float4* a4 = reinterpret_cast<float4*>(A);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      a4[threadIdx.x + j * HF_THREADS] =
          make_float4(x[j].x + d[j].x, x[j].y + d[j].y, x[j].z + d[j].z,
                      x[j].w + d[j].w);
    __syncthreads();
    if (b + 1 < per_run) {
      const size_t blk = (size_t)(run * per_run + b + 1) * bm * RV + base;
#pragma unroll
      for (int j = 0; j < NV; ++j) d[j] = dag[blk + threadIdx.x + j * HF_THREADS];
    }
    ps_tile_matmul(A, W, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[i][j] += tanhf(acc[i][j]);
    __syncthreads();
  }
  const int r0 = (threadIdx.x >> 5) * 4, c0 = (threadIdx.x & 31) * 4;
  float* part = static_cast<float*>(m.out[1]) + (size_t)cta * PS_TILE_R * PS_TILE_C;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(part + (r0 + i) * PS_TILE_C + c0) =
        make_float4(tot[i][0], tot[i][1], tot[i][2], tot[i][3]);
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), slice, runs)) return;
  const float* parts = static_cast<const float*>(m.out[1]);
  float* out = static_cast<float*>(m.out[0]) + (size_t)slice * PS_TILE_R * PS_TILE_C;
  for (int e = threadIdx.x; e < PS_TILE_R * PS_TILE_C; e += HF_THREADS) {
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < runs; ++k)
      s += __ldcg(parts + ((size_t)k * n_sl + slice) * PS_TILE_R * PS_TILE_C + e);
    out[e] = s;
  }
  if (threadIdx.x == 0) static_cast<int*>(m.out[2])[slice] = 0;
}

// ---------------------------------------------------------------------------
// Dynamic shared memory of each body
// ---------------------------------------------------------------------------
__host__ __device__ inline int paper_smem_bytes(const MemberDesc& m) {
  switch (m.kind) {
    case HF_BNSTATS: return HF_WARPS * 2 * PS_SLICE_C * 4;
    case HF_HIST: return hf_align16(m.i[4] * 4);
    case HF_ETHASH:
    case HF_HASH: return (PS_TILE_C + PS_TILE_R) * PS_TILE_C * 4;
    default: return 0;     // maxpool, upsample, im2col
  }
}
