// Tiled matmul: out (M,N) = x (M,K) @ w (K,N), fp32 accumulation, out in
// x's type; bf16 or fp32, all three of one type, row-major.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:38 (matmul, body :24),
// as src/repro/kernels/ops.py:37 calls it.  The reference's 3-D grid carries
// an fp32 accumulator across its sequential k steps in VMEM; CTAs run in no
// order, so here K is a loop inside one CTA: one CTA per 128 x 128 output
// tile, K staged through shared memory in slabs (double-buffered), the
// accumulators in registers, rows and columns past M and N masked.  Every
// output element's sum runs in one fixed order.
//
// Bound on the card: operations at granite-3-2b's train shapes (8192 rows x
// 2048 @ 2048 x 3072 does 103 GFLOP against 59 MB: 0.104 ms at the bf16
// tensor-core peak).
//   bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on the tensor cores.
//     8 warps as 2 x 4, each a 64 x 32 piece of the tile (4 x 4 fragments,
//     64 fp32 accumulators a thread); 32-deep k slabs copied with cp.async
//     (16-byte chunks, zero-filled past M, N and K), so K % 8 == 0 and
//     N % 8 == 0.  wgmma and TMA are later work.  The mma.sync, cp.async
//     and packing helpers are common.cuh's, shared with the attention tile
//     loop (attention_mma.cuh).
//   fp32: CUDA-core fmaf (no TF32: the reference multiplies in fp32); each
//     thread an 8 x 8 piece of the tile, 8-deep k slabs through registers
//     into shared memory (x transposed), so K % 4 == 0 and N % 4 == 0.
#pragma once

#include "common.cuh"

#define MM_BM 128           // output tile rows
#define MM_BN 128           // output tile columns
#define MM_BK 32            // k slab of the bf16 kernel
#define MM_APAD 8           // x slab row: 40 bf16 (20 words: conflict-free)
#define MM_BPAD 8           // w slab row: 136 bf16 (68 words: conflict-free)
#define MM_F32_BK 8         // k slab of the fp32 kernel

typedef bf16 MmXSlab[MM_BM][MM_BK + MM_APAD];
typedef bf16 MmWSlab[MM_BK][MM_BN + MM_BPAD];

// one k slab from k0: x 128 x 32 and w 32 x 128, 512 16-byte chunks each,
// two of each per thread, as one cp.async group
__device__ __forceinline__ void mm_load_slab(MmXSlab& xs, MmWSlab& ws,
                                             const bf16* x, const bf16* w,
                                             int M, int N, int K, int m0,
                                             int n0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * 256;
    const int r = c >> 2, kc = (c & 3) * 8;
    const bool ok = m0 + r < M && k0 + kc < K;
    cp_async16(&xs[r][kc], ok ? x + (size_t)(m0 + r) * K + k0 + kc : x, ok);
    const int kr = c >> 4, nc = (c & 15) * 8;
    const bool okw = k0 + kr < K && n0 + nc < N;
    cp_async16(&ws[kr][nc], okw ? w + (size_t)(k0 + kr) * N + n0 + nc : w,
               okw);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(256)
    mm_bf16_kernel(const bf16* x, const bf16* w, bf16* out, int M, int N,
                   int K) {
  __shared__ __align__(16) MmXSlab xs[2];
  __shared__ __align__(16) MmWSlab ws[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;     // mma fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;       // warp's 64 x 32 piece
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = (K + MM_BK - 1) / MM_BK;
  mm_load_slab(xs[0], ws[0], x, w, M, N, K, m0, n0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      mm_load_slab(xs[st ^ 1], ws[st ^ 1], x, w, M, N, K, m0, n0,
                   (kt + 1) * MM_BK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + gid;
        const int c = kk + tig * 2;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[st][r][c]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[st][r + 8][c]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[st][r][c + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&xs[st][r + 8][c + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + gid;
        const int k = kk + tig * 2;
        b[j][0] = pack_bf16(ws[st][k][n], ws[st][k + 1][n]);
        b[j][1] = pack_bf16(ws[st][k + 8][n], ws[st][k + 9][n]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // accumulator e of fragment (i, j): row gid (+8 for e >= 2), columns
  // tig * 2 + (e & 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + gid + h * 8;
        if (row < M && col < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(256)
    mm_f32_kernel(const float* x, const float* w, float* out, int M, int N,
                  int K) {
  __shared__ __align__(16) float xs[2][MM_F32_BK][MM_BM + 4];   // x^T slab
  __shared__ __align__(16) float ws[2][MM_F32_BK][MM_BN + 4];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // rows ty*4 (+64), cols tx*4 (+64)
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const int xr = tid >> 1, xk = (tid & 1) * 4;     // this thread's x load
  const int wk = tid >> 5, wc = (tid & 31) * 4;    // this thread's w load
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 xv, wv;
  // the slab at k0 into registers (zeros past M, N and K)
#define MM_F32_FETCH(k0)                                                    \
  xv = (m0 + xr < M && (k0) + xk < K)                                       \
           ? *reinterpret_cast<const float4*>(x + (size_t)(m0 + xr) * K +   \
                                              (k0) + xk)                    \
           : zero;                                                          \
  wv = ((k0) + wk < K && n0 + wc < N)                                       \
           ? *reinterpret_cast<const float4*>(w + (size_t)((k0) + wk) * N + \
                                              n0 + wc)                      \
           : zero;
  // the registers into shared slab st, x transposed
#define MM_F32_STASH(st)                                 \
  xs[st][xk][xr] = xv.x;                                 \
  xs[st][xk + 1][xr] = xv.y;                             \
  xs[st][xk + 2][xr] = xv.z;                             \
  xs[st][xk + 3][xr] = xv.w;                             \
  *reinterpret_cast<float4*>(&ws[st][wk][wc]) = wv;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = (K + MM_F32_BK - 1) / MM_F32_BK;
  MM_F32_FETCH(0)
  MM_F32_STASH(0)
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      MM_F32_FETCH((kt + 1) * MM_F32_BK)
    }
#pragma unroll
    for (int k = 0; k < MM_F32_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[st][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[st][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[st][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[st][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) {
      MM_F32_STASH(st ^ 1)
    }
    __syncthreads();
  }
#undef MM_F32_FETCH
#undef MM_F32_STASH

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col < N)
        *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int hf_matmul(const void* x, const void* w, void* out, int M, int N, int K,
              int fp32, void* stream) {
  const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    mm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(out), M, N, K);
  else
    mm_bf16_kernel<<<grid, 256, 0, s>>>(static_cast<const bf16*>(x),
                                        static_cast<const bf16*>(w),
                                        static_cast<bf16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
