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
// maxpool 512 CTAs of 16 rows, upsample 256 of 16, im2col 256 of 16,
// hash_like 128 of 32 rows.  bnstats departs: 8 CTAs a step, 256 of 64 rows
// x all columns at the defaults, one wave at two CTAs an SM; so does hist:
// 4 a step, 128 CTAs of 16 rows, one wave.
// ethash_like departs too: 16 slices of 32 output rows x 8 runs of 16 DAG
// blocks = 128 CTAs (one per grid step), which keeps its partials at 2 MB.
//
// Bounds on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32, 495 TFLOP/s
// TF32): maxpool, upsample, im2col, bnstats and hist by bytes; hash_like by
// fp32 operations; ethash_like (34 MB and 2.17 GFLOP at the defaults) by its
// three TF32 products on the tensor cores.  The streaming bodies move
// 16-byte vectors; hash_like keeps w in registers and the state in shared
// memory, ethash_like w and a ring of DAG blocks in shared memory (see the
// bodies).  Products are explicit fmaf or mma.sync (the build uses
// -fmad=false, so nothing else is contracted).  tanh is tanhf.
//
// Carries.  bnstats, hist and ethash_like accumulate across TPU grid steps.
// Here every CTA writes a partial into a workspace its member owns, calls
// __threadfence(), and takes an atomic ticket of its group; the CTA that draws
// the group's last ticket sums the group's partials in CTA order, writes the
// output (or, for bnstats, the group's partial, summed in group order by the
// last group's last CTA) and resets the ticket.  No CTA waits for another, so
// a launch with more CTAs than fit on the card cannot deadlock, and no float
// atomic touches an output, so the result is the same whatever order the
// CTAs run in: a fused launch is bitwise equal to the member launched alone.
// hist's partials are integer counts, summed with integer atomics (exact
// in any order).  The workspace persists across launches (kernels/cuda.py
// workspace, zeroed once when it is made): each body leaves its tickets,
// and hist its counts, at zero when it ends, so a launch allocates nothing.
//
// Descriptor: i[0] = R (input rows; the DAG's for ethash_like), i[1] = C,
// i[2] = dtype (0 bf16, 1 fp32), i[3] = rows per CTA, then per body:
//   im2col   i[4] = K
//   hist     i[4] = bins, f[0] = bins / 8
//   ethash   i[4] = seed rows (bm), i[5] = runs per slice
//   hash     i[4] = rounds
// in = the op's inputs; out[0] = the output; out[1] = workspace (partials,
// or hist's counts), out[2] = tickets (int, zero between launches).
#pragma once

#include "common.cuh"

#define PS_TILE_C 128      // matmul bodies: columns (= the reference's LANES)
#define PS_TILE_R 32       // matmul bodies: rows of a tile
#define PS_UNROLL 4        // streaming bodies: 16-byte loads in flight per thread
#define BN_UNROLL 8        // bnstats: 16-byte loads in flight per thread
#define BN_GROUP 16        // bnstats: CTAs whose partials one CTA sums first
#define ET_SLOTS 2         // ethash_like: DAG blocks in the cp.async ring

// ---------------------------------------------------------------------------
// maxpool: (R, C) -> (R/2, C), the max of each row pair.  CTA = i[3] rows
// (16 at the defaults: 512 CTAs, 16 a grid step); a thread issues all its
// 16-byte loads of both rows of its pairs (8 fp32, 4 bf16 at the defaults)
// before its first max, with the streaming hint (ld.global.cs: evict first
// in L2), and stores with st.global.cs.  The max is torch.amax's and the
// reference's: a NaN in either row propagates, and +0 wins over -0 in
// either order (a when a is NaN, when a > b, or when a == b and b carries
// the sign bit; else b).  Bound by bytes (16 + 8 MB fp32 at the defaults: 0.0075
// ms).  On the H100 the hints take 1.4 us off when a producer has just
// written the input (0.0082 against 0.0096 ms with neither, no flush) and
// cost 3 us when maxpool runs back to back on one input, which the load
// hint evicts for the next run (0.0125 against 0.0093 ms) (scripts/
// member_variants.py maxpool_produced, maxpool_cached).  One-member
// launches run in bundle.cu's hf_stream: 4 CTAs an SM, so the 512 CTAs are
// one wave.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float ps_max(float a, float b) {
  return (a != a || a > b || (a == b && signbit(b))) ? a : b;
}

__device__ __forceinline__ uint4 ps_max4(uint4 a, uint4 b) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  const float4 r = make_float4(ps_max(x.x, y.x), ps_max(x.y, y.y),
                               ps_max(x.z, y.z), ps_max(x.w, y.w));
  return *reinterpret_cast<const uint4*>(&r);
}

__device__ __forceinline__ uint4 ps_max8(uint4 a, uint4 b) {
  const bf16* x = reinterpret_cast<const bf16*>(&a);
  const bf16* y = reinterpret_cast<const bf16*>(&b);
  uint4 r;
  bf16* o = reinterpret_cast<bf16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float fx = bf2f(x[j]), fy = bf2f(y[j]);
    o[j] = (fx != fx || fx > fy || (fx == fy && signbit(fy))) ? x[j] : y[j];
  }
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
        a[u] = __ldcs(x + (2 * r) * cv + c);
        b[u] = __ldcs(x + (2 * r + 1) * cv + c);
      }
    }
#pragma unroll
    for (int u = 0; u < PS_UNROLL; ++u) {
      const int v = v0 + u * HF_THREADS;
      if (v >= n) break;
      __stcs(out + v, m.i[2] ? ps_max4(a[u], b[u]) : ps_max8(a[u], b[u]));
    }
  }
}

// ---------------------------------------------------------------------------
// upsample: (R, C) -> (2R, C), every row twice.  CTA = i[3] rows (16 at the
// defaults: 256 CTAs, 16 a grid step, one wave at two CTAs an SM).  Thread t
// owns the CTA's 16-byte vectors t, t + 256, ...: it issues up to UP_UNROLL
// loads (all of its vectors at the defaults: 8 fp32, 4 bf16) before its first
// store, then stores each vector into both output rows, back to back.  The
// row of its next vector moves by HF_THREADS / cv (and one more where the
// column wraps), so the loop divides once a trip.  Bound by bytes (8 + 16 MB
// fp32 at the defaults: 0.0075 ms).  On the H100 a TMA bulk copy was slower,
// hf_stream no faster, and the streaming hints slowed a consumer of the
// output or a repeat on one input (scripts/member_variants.py; PERF.md §6).
// ---------------------------------------------------------------------------
#define UP_UNROLL 8        // upsample: 16-byte loads in flight per thread

__device__ void upsample_member(const MemberDesc& m, int cta) {
  const int C = m.i[1], rows = m.i[3];
  const int cv = C * (m.i[2] ? 4 : 2) / 16;     // 16-byte vectors per row
  const uint4* x = static_cast<const uint4*>(m.in[0]) + (size_t)cta * rows * cv;
  uint4* out = static_cast<uint4*>(m.out[0]) + (size_t)cta * 2 * rows * cv;
  const int n = rows * cv;
  const int dr = HF_THREADS / cv, dc = HF_THREADS % cv;
  for (int v0 = threadIdx.x; v0 < n; v0 += UP_UNROLL * HF_THREADS) {
    uint4 a[UP_UNROLL];                         // all loads first
#pragma unroll
    for (int u = 0; u < UP_UNROLL; ++u) {
      const int v = v0 + u * HF_THREADS;
      if (v < n) a[u] = x[v];
    }
    int r = v0 / cv, c = v0 % cv;
#pragma unroll
    for (int u = 0; u < UP_UNROLL; ++u) {
      if (v0 + u * HF_THREADS >= n) break;
      uint4* o = out + (size_t)(2 * r) * cv + c;  // rows 2r and 2r + 1
      o[0] = a[u];
      o[cv] = a[u];
      r += dr;
      c += dc;
      if (c >= cv) { c -= cv; ++r; }
    }
  }
}

// ---------------------------------------------------------------------------
// im2col: (R, C) -> (R, K*C); block k of a row is the row rotated left by
// s_k = k < C ? k : 0 (the reference concatenates x[:, k:] and x[:, :k], so a
// block with k >= C is the row itself).  CTA = i[3] rows (16 at the defaults:
// 256 CTAs, 16 a grid step); thread t builds the 16-byte output vectors t, t +
// 256, ... of the CTA's rows from VEC scalar loads of the row: c + s_k + j <
// 2C, so one wrap at most and no read leaves the row.  Bound by bytes (8 MB
// read, 32 MB written fp32 at the defaults: 0.0125 ms).  Kept at half its
// bound: one PyTorch call of the same function, torch.index_select of the
// rotations' columns, is slower on the H100 (PERF.md §6).
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
      const int src = c + (k < C ? k : 0) + j;
      ot[j] = row[src < C ? src : src - C];
    }
    *reinterpret_cast<uint4*>(out + (r0 + r) * K * C + e) = o;
  }
}

__device__ void im2col_member(const MemberDesc& m, int cta) {
  if (m.i[2]) im2col_rows<float>(m, cta); else im2col_rows<bf16>(m, cta);
}

// ---------------------------------------------------------------------------
// bnstats: (R, C) -> (2, C) fp32 column sums of x and x*x, one wave of CTAs
// streaming contiguous rows.  CTA = a run of i[3] rows x all C columns (64
// rows, 128 KB fp32 at the defaults: 256 CTAs, 2 an SM).  Thread t owns the
// 16-byte column vector t % nv (nv = C / VEC vectors a row) of the row group
// t / nv (G = 256 / nv groups; threads past G * nv only combine): it sums the
// rows g, g + G, ... in row order, BN_UNROLL loads in flight.  The G row
// groups' sums are added in group order through shared memory ([G][2][C]
// fp32, 8 KB fp32 / 16 KB bf16), the CTA's partial (2 x C) goes to the
// workspace, and the combine is two fixed-order levels: the last CTA of each
// group of BN_GROUP CTAs sums their partials in CTA order, then the last
// group's last CTA sums the groups' partials in group order into the output.
// Bound by bytes (32 MB fp32 at the defaults): each thread keeps 8 16-byte
// loads in flight, so one wave holds 8 MB in flight, and the serial tail is
// two short sums instead of one CTA's walk through 128 partials.  On the
// H100 a launch costs ~10 us before its bytes (a 32-CTA one: 6.7 us without
// the combine, 10 with it), which leaves fp32 at ~0.025 ms; 16 loads in
// flight, 16 in the combine's sums, 4 or 16 CTAs a step were no faster
// (scripts/member_variants.py).
// Workspace: out[1] = [ctas + groups][2][C] fp32, out[2] = groups + 1
// tickets, reset by the CTAs that draw the last.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void bn_unpack(const uint4& v, float* f) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(&v);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    unpack8(v, f);
  }
}

// out[4 o .. 4 o + 3] = the sum over k < n of src[k * stride + 4 o ...], in
// k order, for every float4 o < n4 of the CTA
__device__ __forceinline__ void bn_sum_parts(float* out, const float* src,
                                             int n, size_t stride, int n4) {
  for (int o = threadIdx.x; o < n4; o += HF_THREADS) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(src + k * stride) + o);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    reinterpret_cast<float4*>(out)[o] = s;
  }
}

template <typename T>
__device__ void bnstats_cta(const MemberDesc& m, int cta) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);   // [G][2][C]
  const int C = m.i[1], rows = m.i[3];
  const int nv = C / VEC, G = HF_THREADS / nv;
  const int g = threadIdx.x / nv, cv = threadIdx.x % nv;
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if (g < G) {
    const uint4* x = reinterpret_cast<const uint4*>(
        static_cast<const T*>(m.in[0]) + (size_t)cta * rows * C) + cv;
    for (int r0 = g; r0 < rows; r0 += BN_UNROLL * G) {
      uint4 v[BN_UNROLL];                        // all loads first
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u)
        if (r0 + u * G < rows) v[u] = x[(size_t)(r0 + u * G) * nv];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        if (r0 + u * G >= rows) break;
        float f[VEC];
        bn_unpack<T>(v[u], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[j] += f[j];
          q[j] += f[j] * f[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      *reinterpret_cast<float4*>(red + (g * 2 + 0) * C + cv * VEC + j) =
          make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
      *reinterpret_cast<float4*>(red + (g * 2 + 1) * C + cv * VEC + j) =
          make_float4(q[j], q[j + 1], q[j + 2], q[j + 3]);
    }
  }
  __syncthreads();
  const int n4 = 2 * C / 4, groups = (m.ctas + BN_GROUP - 1) / BN_GROUP;
  float* part = static_cast<float*>(m.out[1]);   // [ctas + groups][2][C]
  for (int o = threadIdx.x; o < n4; o += HF_THREADS) {
    float4 a = reinterpret_cast<const float4*>(red)[o];
    for (int k = 1; k < G; ++k) {
      const float4 b = reinterpret_cast<const float4*>(red + k * 2 * C)[o];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    reinterpret_cast<float4*>(part + (size_t)cta * 2 * C)[o] = a;
  }
  int* tickets = static_cast<int*>(m.out[2]);
  const int grp = cta / BN_GROUP;
  const int in_grp = min(BN_GROUP, m.ctas - grp * BN_GROUP);
  if (!hf_last_of_group(tickets, grp, in_grp)) return;
  float* gpart = part + (size_t)m.ctas * 2 * C;
  bn_sum_parts(gpart + (size_t)grp * 2 * C, part + (size_t)grp * BN_GROUP * 2 * C,
               in_grp, 2 * C, n4);
  if (threadIdx.x == 0) tickets[grp] = 0;
  if (!hf_last_of_group(tickets, groups, groups)) return;
  bn_sum_parts(static_cast<float*>(m.out[0]), gpart, groups, 2 * C, n4);
  if (threadIdx.x == 0) tickets[groups] = 0;
}

__device__ void bnstats_member(const MemberDesc& m, int cta) {
  if (m.i[2]) bnstats_cta<float>(m, cta); else bnstats_cta<bf16>(m, cta);
}

// ---------------------------------------------------------------------------
// hist: (R, C) fp32 or bf16 -> (1, bins) fp32 counts of trunc(clip((x+4) *
// bins/8, 0, bins-1)), the reference's binning in fp32 (x cast to fp32 first;
// a NaN counts in bin 0, as the reference's cast of it to int32 gives).
// CTA = i[3] rows (16 at the defaults: 128 CTAs, 4 a grid step, one wave at
// one CTA an SM).  A thread issues up to HI_UNROLL 16-byte loads (the
// streaming hint: evict first in L2) before the CTA zeroes its counts, then
// counts each value in its warp's copy of the bins in shared memory
// ([HF_WARPS][bins] ints), so only lanes of one warp contend for a bin.  The
// warp copies are summed in warp order, and the CTA adds each nonzero bin
// with one atomic (no return: a reduction in L2) into the global counts.
// The CTA that draws the last ticket writes the output and zeroes the counts
// and the ticket, as a launch finds them.  Integer counts: exact in any
// order, so a fused launch is bitwise equal to the member alone.  Bound by
// bytes (2 MB at the defaults: 0.0006 ms); on the H100 a launch's fixed cost
// is most of its ~9 us and the combine's serial tail (fence, ticket, the
// last CTA's pass) 1.5 us; 64 or 256 CTAs were no faster, nor were 16
// striped copies of the global counts (scripts/member_variants.py).
// Workspace: out[1] = bins ints, out[2] = one ticket.
// ---------------------------------------------------------------------------
#define HI_UNROLL 8        // hist: 16-byte loads in flight per thread

__device__ __forceinline__ void hist_load(uint4* a, const uint4* x, int v0,
                                          int n) {
#pragma unroll
  for (int u = 0; u < HI_UNROLL; ++u) {
    const int v = v0 + u * HF_THREADS;
    if (v < n) a[u] = __ldcs(x + v);
  }
}

template <typename T>
__device__ void hist_cta(const MemberDesc& m, int cta) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  int* wcnt = reinterpret_cast<int*>(smem);            // [HF_WARPS][bins]
  const int C = m.i[1], rows = m.i[3], bins = m.i[4];
  const float scale = m.f[0], top = (float)(bins - 1);
  const int n = rows * C / VEC;                        // the CTA's vectors
  const uint4* x = reinterpret_cast<const uint4*>(
      static_cast<const T*>(m.in[0]) + (size_t)cta * rows * C);
  uint4 a[HI_UNROLL];
  hist_load(a, x, threadIdx.x, n);                  // in flight while
  for (int b = threadIdx.x; b < HF_WARPS * bins; b += HF_THREADS)  // zeroing
    wcnt[b] = 0;
  __syncthreads();
  int* cnt = wcnt + (threadIdx.x >> 5) * bins;
  for (int v0 = threadIdx.x; v0 < n; v0 += HI_UNROLL * HF_THREADS) {
    if (v0 != threadIdx.x) hist_load(a, x, v0, n);
#pragma unroll
    for (int u = 0; u < HI_UNROLL; ++u) {
      if (v0 + u * HF_THREADS >= n) break;
      float f[VEC];
      bn_unpack<T>(a[u], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = __fmul_rn(__fadd_rn(f[j], 4.0f), scale);
        atomicAdd(cnt + (int)fminf(fmaxf(t, 0.0f), top), 1);
      }
    }
  }
  __syncthreads();
  int* tot = static_cast<int*>(m.out[1]);
  for (int b = threadIdx.x; b < bins; b += HF_THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < HF_WARPS; ++w) s += wcnt[w * bins + b];
    if (s) atomicAdd(tot + b, s);
  }
  int* ticket = static_cast<int*>(m.out[2]);
  if (!hf_last_of_group(ticket, 0, m.ctas)) return;
  float* out = static_cast<float*>(m.out[0]);
  for (int b = threadIdx.x; b < bins; b += HF_THREADS) {
    out[b] = (float)__ldcg(tot + b);
    tot[b] = 0;
  }
  if (threadIdx.x == 0) ticket[0] = 0;
}

__device__ void hist_member(const MemberDesc& m, int cta) {
  if (m.i[2]) hist_cta<float>(m, cta); else hist_cta<bf16>(m, cta);
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
// step, so the member keeps its 80 KB a CTA), and the 256
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
// ethash_like: out (bm, 128) = sum over DAG blocks s of tanh((x + dag_s) @ w),
// the product in 3xTF32 on the tensor cores.
//
// CTA local = run * n_slices + slice owns output rows [32 slice, +32) over
// the run's DAG blocks, in order.  w (64 KB) is copied once a CTA into shared
// memory, row-major; the run's 32-row slices of the DAG blocks stream through
// a ring of ET_SLOTS slots by cp.async (block b + 1 lands while block b is
// multiplied), and each thread adds x to the 16-byte chunks it copied, so
// A = x + dag forms in place.  Warp w owns output rows 16 (w / 4) .. +16 and
// columns 32 (w % 4) .. +32: one m16 tile x four n8 tiles of
// mma.sync.m16n8k8 TF32.  Each fp32 operand is split at its fragment load
// into hi = rna(v) and lo = rna(v - hi) (rna: cvt.rna.tf32.f32's rounding,
// done by integer operations; see tf32_rna), and three
// products run into one fp32 accumulator: lo.hi, hi.lo, then hi.hi.  That
// keeps about fp32's accuracy (a scratch emulation at the defaults: 1.8e-6 of
// 1 + |want| against fp64, fp32 7.8e-7; one TF32 product 8.3e-3, over the
// 1e-4 tolerance).  tanhf and the sum over the run's blocks stay in
// registers; the order of every output is fixed, so a fused launch is
// bitwise equal to the member alone.
//
// Fragments.  k runs in groups of 16: mma step s of group p takes as lane
// t's (t = lane % 4) logical k = t and t + 4 the k rows 16 p + 4 t + 2 s and
// + 1, so a lane's A values for both steps are one 16-byte load of its row.
// n tile j holds the warp's columns 4 n' + j (n' = 0..7), so lane g's (g =
// lane / 4) w values are four 16-byte loads, columns 4 g .. 4 g + 3 of the
// rows 16 p + 4 t .. + 3, and a row's accumulators are 8 adjacent columns,
// 8 t .. 8 t + 7.  Both tiles XOR their 16-byte chunks (A by the row's
// parity, w by (k / 4) % 4) so each 8 lanes of a load hit 32 distinct banks.
//
// Bound by the tensor cores (3 x 2.17 GFLOP at 495 TFLOP/s: 0.0130 ms at the
// defaults; 34 MB at 3.35 TB/s: 0.0102 ms).  On the H100 mma.sync reaches
// about 200 TFLOP/s of TF32, so the three products alone take ~33 us of the
// body's ~0.065 ms; the fragments' shared-memory loads (192 KB a block a
// CTA), tanhf (~5 us) and the launch fill the rest.  Neither twice the CTAs
// (two an SM), a second accumulator, the k loop unrolled whole nor the split
// left out moved it by more than 2% (scripts/member_variants.py).  hf_paper's
// __launch_bounds__(256, 2) holds the body to 128 registers (not inlined, so
// the bundle instances keep their allocation) and it takes 96 KB of shared
// memory (w 64 KB + two 16 KB slots), so two CTAs of any paper launch still
// fit an SM.  Workspace: out[1] = [ctas][32][128] fp32 partials, out[2] =
// a ticket per slice; the slice's last CTA adds the runs' partials in run
// order and resets its ticket.
// ---------------------------------------------------------------------------
// float offset of 16-byte chunk c of row r of the A tile / of w's row k
__device__ __forceinline__ int et_a_at(int r, int c) {
  return r * PS_TILE_C + ((c ^ ((r & 1) << 2)) << 2);
}
__device__ __forceinline__ int et_w_at(int k, int c) {
  return k * PS_TILE_C + ((c ^ (((k >> 2) & 3) << 1)) << 2);
}

// fp32 -> TF32 as cvt.rna.tf32.f32 (round to nearest, ties away from zero),
// by integer operations on the bits: add half of TF32's last place to the
// magnitude (a carry moves into the exponent), clear the 13 bits TF32 drops.
// The same result for every finite value short of overflow, in two
// full-rate integer instructions: the conversion itself issues at a
// fraction of their rate and held the body at 0.0786 ms
// (scripts/member_variants.py ethash_cvt).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32: hi = v rounded, lo = the (exact) rest rounded
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32_1688(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// this thread's chunks (row idx / 32, chunk idx % 32, idx = thread + 256 u)
// of a 32-row DAG slice into a ring slot
__device__ __forceinline__ void et_copy_block(float* slot, const float* src) {
#pragma unroll
  for (int u = 0; u < PS_TILE_R * PS_TILE_C / 4 / HF_THREADS; ++u) {
    const int idx = threadIdx.x + u * HF_THREADS, r = idx >> 5, c = idx & 31;
    cp_async16(slot + et_a_at(r, c), src + r * PS_TILE_C + 4 * c, true);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __noinline__ void ethash_member(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* W = reinterpret_cast<float*>(smem);
  float* ring = W + PS_TILE_C * PS_TILE_C;            // [ET_SLOTS][32][128]
  const int R = m.i[0], bm = m.i[4], runs = m.i[5];
  const int n_sl = bm / PS_TILE_R, per_run = R / bm / runs;
  const int slice = cta % n_sl, run = cta / n_sl;
  const float* dag = static_cast<const float*>(m.in[0]) +
                     ((size_t)run * per_run * bm + slice * PS_TILE_R) * PS_TILE_C;
  const float* xs = static_cast<const float*>(m.in[1]) +
                    (size_t)slice * PS_TILE_R * PS_TILE_C;
  const float* w = static_cast<const float*>(m.in[2]);
  for (int idx = threadIdx.x; idx < PS_TILE_C * PS_TILE_C / 4; idx += HF_THREADS) {
    const int k = idx >> 5, c = idx & 31;
    cp_async16(W + et_w_at(k, c), w + k * PS_TILE_C + 4 * c, true);
  }
  et_copy_block(ring, dag);                 // w and block 0: one group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 2) * 16, n0 = (warp & 3) * 32;
  float tot[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[j][i] = 0.f;
  for (int b = 0; b < per_run; ++b) {
    float* A = ring + (b % ET_SLOTS) * PS_TILE_R * PS_TILE_C;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < PS_TILE_R * PS_TILE_C / 4 / HF_THREADS; ++u) {
      const int idx = threadIdx.x + u * HF_THREADS, r = idx >> 5, c = idx & 31;
      float4* a = reinterpret_cast<float4*>(A + et_a_at(r, c));
      const float4 x = __ldg(reinterpret_cast<const float4*>(xs + r * PS_TILE_C) + c);
      const float4 d = *a;
      *a = make_float4(x.x + d.x, x.y + d.y, x.z + d.z, x.w + d.w);
    }
    __syncthreads();        // A visible; every warp is past block b - 1
    if (b + 1 < per_run)
      et_copy_block(ring + ((b + 1) % ET_SLOTS) * PS_TILE_R * PS_TILE_C,
                    dag + (size_t)(b + 1) * bm * PS_TILE_C);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 2
    for (int p = 0; p < PS_TILE_C / 16; ++p) {
      const float4 v0 = *reinterpret_cast<const float4*>(A + et_a_at(m0 + g, 4 * p + t));
      const float4 v1 = *reinterpret_cast<const float4*>(A + et_a_at(m0 + g + 8, 4 * p + t));
      float4 wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[i] = *reinterpret_cast<const float4*>(
            W + et_w_at(16 * p + 4 * t + i, (n0 >> 2) + g));
      const float a0[4] = {v0.x, v1.x, v0.y, v1.y}, a1[4] = {v0.z, v1.z, v0.w, v1.w};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) tf32_split(s ? a1[i] : a0[i], ah[i], al[i]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 v = wv[2 * s + i];
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) tf32_split(e[j], bh[j][i], bl[j][i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_1688(acc[j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_1688(acc[j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_1688(acc[j], ah, bh[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[j][i] += tanhf(acc[j][i]);
  }
  float* part = static_cast<float*>(m.out[1]) + (size_t)cta * PS_TILE_R * PS_TILE_C +
                (m0 + g) * PS_TILE_C + n0 + 8 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {             // rows g and g + 8 of the tile
    float* row = part + h * 8 * PS_TILE_C;
    *reinterpret_cast<float4*>(row) =
        make_float4(tot[0][2 * h], tot[1][2 * h], tot[2][2 * h], tot[3][2 * h]);
    *reinterpret_cast<float4*>(row + 4) = make_float4(
        tot[0][2 * h + 1], tot[1][2 * h + 1], tot[2][2 * h + 1], tot[3][2 * h + 1]);
  }
  if (!hf_last_of_group(static_cast<int*>(m.out[2]), slice, runs)) return;
  const float4* parts = static_cast<const float4*>(m.out[1]);
  float4* out = static_cast<float4*>(m.out[0]) + (size_t)slice * PS_TILE_R * PS_TILE_C / 4;
  constexpr int TV = PS_TILE_R * PS_TILE_C / 4;      // float4s of a tile
  for (int e = threadIdx.x; e < TV; e += HF_THREADS) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = 0; k < runs; ++k) {
      const float4 p = __ldcg(parts + ((size_t)k * n_sl + slice) * TV + e);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    out[e] = s;
  }
  if (threadIdx.x == 0) static_cast<int*>(m.out[2])[slice] = 0;
}

// ---------------------------------------------------------------------------
// Dynamic shared memory of each body
// ---------------------------------------------------------------------------
__host__ __device__ inline int paper_smem_bytes(const MemberDesc& m) {
  switch (m.kind) {
    case HF_BNSTATS: {               // [G][2][C] fp32, G = 256 / (C / VEC)
      const int nv = m.i[1] / (m.i[2] ? 4 : 8);
      return HF_THREADS / nv * 2 * m.i[1] * 4;
    }
    case HF_HIST: return HF_WARPS * m.i[4] * 4;     // the warps' bins
    case HF_ETHASH: return (PS_TILE_C + ET_SLOTS * PS_TILE_R) * PS_TILE_C * 4;
    case HF_HASH: return (PS_TILE_C + PS_TILE_R) * PS_TILE_C * 4;
    default: return 0;     // maxpool, upsample, im2col
  }
}
