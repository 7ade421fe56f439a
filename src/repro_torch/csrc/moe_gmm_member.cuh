// Grouped expert FFN member (MoE): E expert FFNs in one launch, the
// framework's own instance of horizontal fusion.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:54 (moe_gmm_op, and
// :34 moe_gmm, the same member launched alone).  Per expert e:
//   h  = act(gate) * up  with [gate | up] = xe[e] @ w_in[e]   (fp32 sums)
//   ye = bf16(bf16(h) @ w_out[e])                               (fp32 sums)
// as _gmm_kernel (:21-31) computes it: the activation in fp32 on the
// unrounded product, h rounded to bf16 before the second product.
//
// Bound on the card: bytes.  At decode (C = 8 rows per expert) it streams all
// E experts' weights once (2.52 GB at phi3.5-moe: 16 x 4096 x 12800 + 16 x
// 6400 x 4096 bf16) and does 2 * C flops per weight element, far below the
// tensor cores' ridge even at C 128.  What counts is that each weight byte
// leaves device memory once and that enough of them are in flight.  Design:
//
// - CTAs.  A CTA owns one f-tile of FT = i[4] hidden columns of one expert
//   (kernels/moe_gmm.py f_tile: the largest multiple of 32 dividing f, at
//   most 640): E * f / FT CTAs, 160 at phi3.5-moe (FT 640), all resident
//   at once on the H100's 132 SMs (at FT 320, 320 CTAs ran as 264 and then
//   56: PERF.md).  The tile's columns come in blocks of up to 128, one per
//   sweep, and the expert's T tiles take each sweep's blocks side by side
//   (gmm_hidden), so the expert's CTAs read each weight row's blocks
//   together.
// - Tensor cores.  Both products run on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulators), weights on the 16-row side and tokens on the 8-column
//   side: (w_in^T)(xe^T) and (w_out^T)(h^T), so a capacity of 8 fills an
//   mma with no padding.  Weight fragments come by ldmatrix.trans from the
//   staged boxes (rows of 128 bytes, 16-byte chunks swizzled), token
//   fragments by ldmatrix.
// - Passes.  A pass holds R = i[6] token rows (kernels/moe_gmm.py
//   pass_rows: at most 40, five 8-column groups) and streams the
//   CTA's weights once; every weight slice is applied to all the pass's row
//   groups.  ceil(C / 40) passes: each weight byte leaves device memory once
//   a launch at C <= 40, twice at C 80 (the TPU-era design, rows in blocks
//   of 8, streamed it ceil(C / 8) times).  The limit is registers: the
//   bundle kernel is __launch_bounds__(256, 2), 128 a thread, and a pass
//   takes 2 * R / 8 * 4 = R fp32 accumulators a thread (gate and up, or two
//   16-column output tiles), one array shared by both products.  The body
//   is compiled once per R / 8 (1..5), so a decode launch (R 8) holds 8
//   accumulators, not 40.
// - The stream.  Product 1 runs in sweeps of 128 hidden columns (8 warps x
//   16, each warp the gate and up tiles of its 16 columns) over k in slices
//   of 32 rows; the sweep's h (act in fp32, rounded to bf16) goes into the
//   pass's h tile [R][FT] in shared memory.  Product 2 runs in chunks of 256
//   output columns (8 warps x 32) over the tile's FT hidden rows in slices of
//   32.  Every slice (16 KB of weights, and in product 1 the pass's 32 k
//   columns of xe) goes through one ring of 2..6 stages in shared memory
//   (gmm_stages: as many as fit 112 KB beside the h tile, so a fused launch
//   keeps 2 CTAs an SM beside the prefill member's 85 KB), the next slices
//   in flight while the tensor cores work on this one.  The weights come as
//   TMA boxes (cp.async.bulk.tensor: 32 rows x 64 columns, 128-byte
//   swizzle, zeros past the matrix, so a ragged d needs no masking), issued
//   by one thread and landing on the stage's mbarrier; xe comes by
//   cp.async.  Per-thread 16-byte copies of the weights streamed at most
//   about 2.3 TB/s on the H100 (PERF.md).
// - Partials.  Product 2's chunk of a pass goes into a per-launch workspace
//   (E, T, C, d) fp32 (T = f / FT): 21 MB at decode, 0.8% over the weight
//   stream; 210 MB at C 80.  Each CTA then takes a ticket of its
//   (expert, pass, chunk) after __threadfence(), and that triple's last CTA
//   sums the T tiles' partials in tile order and stores ye's chunk, so the
//   combine is spread over the launch.  No waits, no float atomics: a fused
//   launch is bitwise equal to the member launched alone.
//
// The body is a non-inlined call (one per R / 8): code inlined into
// hf_bundle moves every other member's register allocation (PERF.md).
//
// Descriptor: i[0] = E, i[1] = C, i[2] = d, i[3] = f, i[4] = FT, i[5] = act
// (row_member.cuh: 0 silu-gated, 1 gelu-gated, 2 gelu), i[6] = R.  in = xe
// (E,C,d), w_in (E,d,2f or f), w_out (E,f,d) bf16, in[3] = their two TMA
// tensor maps (bundle.cu hf_gmm_tmaps, kernels/cuda.py gmm_tensor_maps);
// out[0] = ye (E,C,d) bf16, out[1] = the partials, out[2] = E * passes *
// ceil(d / 256) tickets (int, zeroed).
#pragma once

#include "row_member.cuh"

#define GMM_KT 32               // rows of a weight slice
#define GMM_SW 128              // hidden columns of a product-1 sweep
#define GMM_JC 256              // output columns of a product-2 chunk
#define GMM_BOX 4096            // one TMA box: 32 rows x 64 bf16 (128 B)
#define GMM_LDX (GMM_KT + 8)    // bf16 row stride of a staged xe slice
#define GMM_SMEM_CAP (112 * 1024)
#define GMM_MAX_STAGES 6

// one ring slot: four boxes of weights (16 KB) | the xe slice, rounded up to
// 1024 bytes (a 128-byte-swizzled box starts on a 1024-byte boundary)
__host__ __device__ inline int gmm_stage_bytes(const MemberDesc& m) {
  return (4 * GMM_BOX + m.i[6] * GMM_LDX * 2 + 1023) & ~1023;
}
__host__ __device__ inline int gmm_h_bytes(const MemberDesc& m) {
  return m.i[6] * (m.i[4] + 8) * 2;
}
// ring stages: as many as fit GMM_SMEM_CAP beside the h tile, 2..6
__host__ __device__ inline int gmm_stages(const MemberDesc& m) {
  const int n = (GMM_SMEM_CAP - 1024 - gmm_h_bytes(m)) / gmm_stage_bytes(m);
  return n < 2 ? 2 : n > GMM_MAX_STAGES ? GMM_MAX_STAGES : n;
}
// shared memory: 1024 bytes of alignment slack | ring [stages][weights | xe]
// | h tile [R][FT + 8] | an mbarrier per stage
__host__ __device__ inline int gmm_smem_bytes(const MemberDesc& m) {
  return 1024 + gmm_stages(m) * gmm_stage_bytes(m) + gmm_h_bytes(m) +
         8 * GMM_MAX_STAGES;
}

// cp.async.wait_group with the count known only at run time
__device__ __forceinline__ void gmm_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::); break;
  }
}

// box (64 columns from col, 32 rows from row) of expert e's matrix; out of
// bounds (rows past d, columns past the matrix) lands as zeros
__device__ __forceinline__ void gmm_box(void* dst, const void* tmap, int col,
                                        int row, int e, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(hf_saddr(dst)),
      "l"(tmap), "r"(col), "r"(row), "r"(e), "r"(hf_saddr(bar))
      : "memory");
}
// where a box keeps row r, columns c.. (c % 8 == 0): rows of 128 bytes, the
// 16-byte chunks swizzled (chunk ^ row % 8), so the 8 rows an ldmatrix
// reads fall in 8 different bank groups
__device__ __forceinline__ const bf16* gmm_at(const bf16* box, int r, int c) {
  return box + r * 64 + (((c >> 3) ^ (r & 7)) << 3);
}

// The first hidden column of a CTA's sweep s0.. (sw columns): the T
// f-tiles of an expert take their sweeps' column blocks side by side, so
// the expert's CTAs, which run in step, read each weight row's columns
// s0 * T .. + sw * T together.
__device__ __forceinline__ int gmm_hidden(int T, int t, int s0, int sw) {
  return T * s0 + t * sw;
}

// Where one slice of the stream sits: pass p; product 1 (ph 0): sweep sub,
// k slice ks; product 2 (ph 1): output chunk jc, hidden slice ns.
struct GmmPos {
  int p, ph, a, b;          // a: sub or jc, b: ks or ns
  __device__ void next(int nsub, int nk, int njc, int nn) {
    if (++b < (ph == 0 ? nk : nn)) return;
    b = 0;
    if (++a < (ph == 0 ? nsub : njc)) return;
    a = 0;
    if (ph == 1) ++p;
    ph ^= 1;
  }
};

template <int NT>   // 8-column groups of a pass: R = 8 * NT token rows
__device__ __noinline__ void moe_gmm_mma(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = m.i[1], d = m.i[2], f = m.i[3], FT = m.i[4], act = m.i[5],
            R = m.i[6];
  const bool gated = act_gated(act);
  const int T = f / FT, e = cta / T, t = cta % T;
  const int npass = (C + R - 1) / R;
  const int nsub = (FT + GMM_SW - 1) / GMM_SW, nk = (d + GMM_KT - 1) / GMM_KT;
  const int njc = (d + GMM_JC - 1) / GMM_JC, nn = FT / GMM_KT;
  const int N = npass * (nsub * nk + njc * nn);
  const int stages = gmm_stages(m), sbytes = gmm_stage_bytes(m);
  const int LDH = FT + 8;
  const bf16* xe = static_cast<const bf16*>(m.in[0]) + (size_t)e * C * d;
  // the tensor maps of w_in (E, d, 2f or f) and w_out (E, f, d): in[3]
  const unsigned char* tmaps = static_cast<const unsigned char*>(m.in[3]);
  float* part = static_cast<float*>(m.out[1]);
  unsigned char* smem = smem_raw + ((1024 - (hf_saddr(smem_raw) & 1023)) &
                                    1023);
  bf16* hs = reinterpret_cast<bf16*>(smem + stages * sbytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * sbytes +
                                               gmm_h_bytes(m));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // The loader.  Thread 0 brings a slice's weights as TMA boxes of 32 rows
  // x 64 columns (product 1: the gate and up blocks of the sweep's columns,
  // two boxes each; product 2: the output chunk's 256 columns, four boxes)
  // completing on the stage's mbarrier; the xe slice (row tid / 4, columns
  // (tid % 4) * 8) comes by cp.async, one commit group per slice.
  if (tid == 0)
    for (int st = 0; st < stages; ++st) hf_bar_init(bars + st, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  GmmPos lp{0, 0, 0, 0};
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  int li = 0;
  auto load = [&]() {
    if (li < N) {
      uint64_t* bar = bars + li % stages;
      unsigned char* W = smem + (li % stages) * sbytes;
      const int k0 = lp.b * GMM_KT;
      if (lp.ph == 0) {             // w_in rows k0.., xe columns k0..
        const int s0 = lp.a * GMM_SW, sw = min(GMM_SW, FT - s0);
        const int col0 = gmm_hidden(T, t, s0, sw), nb = (sw + 63) / 64;
        if (tid == 0) {
          hf_bar_expect(bar, (gated ? 2 : 1) * nb * GMM_BOX);
          for (int b = 0; b < nb; ++b) {
            gmm_box(W + b * GMM_BOX, tmaps, col0 + 64 * b, k0, e, bar);
            if (gated)
              gmm_box(W + (2 + b) * GMM_BOX, tmaps, f + col0 + 64 * b, k0, e,
                      bar);
          }
        }
        if (xr < R) {
          const int row = lp.p * R + xr, k = k0 + xc;
          const bool ok = row < C && k < d;
          cp_async16(W + 4 * GMM_BOX + (xr * GMM_LDX + xc) * 2,
                     xe + (ok ? (size_t)row * d + k : 0), ok);
        }
      } else {                      // w_out rows of the tile's k0.., chunk jc
        const int j0 = lp.a * GMM_JC, s0 = k0 / GMM_SW * GMM_SW;
        const int row0 = gmm_hidden(T, t, s0, min(GMM_SW, FT - s0)) +
                         k0 - s0;
        if (tid == 0) {
          hf_bar_expect(bar, 4 * GMM_BOX);
          for (int b = 0; b < 4; ++b)
            gmm_box(W + b * GMM_BOX, tmaps + 128, j0 + 64 * b, row0, e, bar);
        }
      }
      lp.next(nsub, nk, njc, nn);
      ++li;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // the pass's accumulators: product 1 [gate | up][nt], product 2 the
  // warp's two 16-column output tiles [mt][nt]
  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[a][nt][0] = acc[a][nt][1] = acc[a][nt][2] = acc[a][nt][3] = 0.0f;

  for (int i = 0; i < stages - 1; ++i) load();
  GmmPos cp{0, 0, 0, 0};
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    gmm_wait(stages - 2);           // slice i has landed: its xe slice,
    hf_bar_wait(bars + i % stages, (i / stages) & 1);   // its weights
    __syncthreads();                // and slot (i - 1) % stages is free
    load();                         // slice i + stages - 1
    const unsigned char* S = smem + (i % stages) * sbytes;
    const bf16* W = reinterpret_cast<const bf16*>(S);
    // an ldmatrix.trans address: lane's row of the slice's k16 step kk,
    // columns c.. of the weights (box c / 64)
    const int ar = (lane >> 4) * 8 + (lane & 7), ac = ((lane >> 3) & 1) * 8;
    if (cp.ph == 0) {
      // product 1: this warp's gate (and up) tile of 16 hidden columns
      const int s0 = cp.a * GMM_SW, sw = min(GMM_SW, FT - s0);
      if (warp * 16 < sw) {
        const bf16* X = reinterpret_cast<const bf16*>(S + 4 * GMM_BOX);
        const int c = warp * 16 + ac;
        const bf16* gbox = W + (c >> 6) * (GMM_BOX / 2);
        uint32_t ag[2][4], au[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          ldsm_x4_trans(ag[kk], gmm_at(gbox, kk * 16 + ar, c & 63));
          if (gated)
            ldsm_x4_trans(au[kk], gmm_at(gbox + GMM_BOX, kk * 16 + ar,
                                         c & 63));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bx[4];
          ldsm_x4(bx, X + (nt * 8 + (lane & 7)) * GMM_LDX + (lane >> 3) * 8);
          mma_bf16_16816(acc[0][nt], ag[0], bx);
          mma_bf16_16816(acc[0][nt], ag[1], bx + 2);
          if (gated) {
            mma_bf16_16816(acc[1][nt], au[0], bx);
            mma_bf16_16816(acc[1][nt], au[1], bx + 2);
          }
        }
        if (cp.b == nk - 1) {       // the sweep's h: act in fp32, bf16
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int hid = s0 + warp * 16 + gid + (v >> 1) * 8;
              const int row = nt * 8 + 2 * tig + (v & 1);
              hs[row * LDH + hid] = f2bf(act_apply(
                  act, acc[0][nt][v], gated ? acc[1][nt][v] : 0.0f));
              acc[0][nt][v] = acc[1][nt][v] = 0.0f;
            }
          }
        }
      }
    } else {
      // product 2: this warp's two 16-column tiles of the output chunk
      const int j0 = cp.a * GMM_JC, n0 = cp.b * GMM_KT;
      if (j0 + warp * 32 < d) {
        uint32_t aw[2][2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int c = warp * 32 + mt * 16 + ac;
            ldsm_x4_trans(aw[mt][kk], gmm_at(W + (c >> 6) * (GMM_BOX / 2),
                                             kk * 16 + ar, c & 63));
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh[4];
          ldsm_x4(bh, hs + (nt * 8 + (lane & 7)) * LDH + n0 + (lane >> 3) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc[mt][nt], aw[mt][0], bh);
            mma_bf16_16816(acc[mt][nt], aw[mt][1], bh + 2);
          }
        }
      }
      if (cp.b == nn - 1) {         // the chunk's partial, then its ticket
        if (j0 + warp * 32 < d) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              {
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  const int j = j0 + warp * 32 + mt * 16 + gid + (v >> 1) * 8;
                  const int row = cp.p * R + nt * 8 + 2 * tig + (v & 1);
                  if (row < C && j < d)
                    part[(((size_t)e * T + t) * C + row) * d + j] =
                        acc[mt][nt][v];
                  acc[mt][nt][v] = 0.0f;
                }
              }
            }
        }
        const int grp = (e * npass + cp.p) * njc + cp.a;
        if (hf_last_of_group(static_cast<int*>(m.out[2]), grp, T)) {
          // the T tiles' partials of the chunk, in tile order, into ye
          const int rows = min(R, C - cp.p * R), cw = min(GMM_JC, d - j0) / 4;
          bf16* ye = static_cast<bf16*>(m.out[0]) + (size_t)e * C * d;
          const size_t tstride = (size_t)C * d, ts4 = tstride / 4;
          for (int idx = tid; idx < rows * cw; idx += HF_THREADS) {
            const int r = idx / cw;
            const size_t at =
                (size_t)(cp.p * R + r) * d + j0 + (idx - r * cw) * 4;
            const float4* src = reinterpret_cast<const float4*>(
                part + (size_t)e * T * tstride + at);
            float4 s = __ldcg(src);
            int u = 1;
            for (; u + 3 < T; u += 4) {     // four loads in flight, then
              float4 a[4];                  // the sums in tile order
#pragma unroll
              for (int q = 0; q < 4; ++q) a[q] = __ldcg(src + (u + q) * ts4);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                s.x += a[q].x;
                s.y += a[q].y;
                s.z += a[q].z;
                s.w += a[q].w;
              }
            }
            for (; u < T; ++u) {
              const float4 a = __ldcg(src + u * ts4);
              s.x += a.x;
              s.y += a.y;
              s.z += a.z;
              s.w += a.w;
            }
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ye + at);
            dst[0] = __floats2bfloat162_rn(s.x, s.y);
            dst[1] = __floats2bfloat162_rn(s.z, s.w);
          }
        }
      }
    }
    cp.next(nsub, nk, njc, nn);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ void moe_gmm_member(const MemberDesc& m, int cta) {
  switch (m.i[6] / 8) {
    case 1: moe_gmm_mma<1>(m, cta); break;
    case 2: moe_gmm_mma<2>(m, cta); break;
    case 3: moe_gmm_mma<3>(m, cta); break;
    case 4: moe_gmm_mma<4>(m, cta); break;
    case 5: moe_gmm_mma<5>(m, cta); break;
    default: __trap();    // pack refuses any other pass (kernels/moe_gmm.py)
  }
}
