// Tiled matmul: out (M,N) = x (M,K) @ w (K,N), fp32 accumulation, out in
// x's type; bf16 or fp32, all three of one type, row-major.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:38 (matmul, body :24),
// as src/repro/kernels/ops.py:37 calls it.  The reference's 3-D grid carries
// an fp32 accumulator across its sequential k steps in VMEM; CTAs run in no
// order, so here K is a loop inside one CTA, the accumulators in registers.
// No split-K: every output element's sum runs in one fixed order, so two
// calls are bitwise equal.
//
// Bound on the card: operations at granite-3-2b's train shapes (8192 rows x
// 2048 @ 2048 x 3072 does 103 GFLOP against 59 MB: 0.104 ms at the bf16
// tensor-core peak).
//   bf16 (mm_bf16_kernel): wgmma, the only way to the tensor cores' full
//     rate, fed by a TMA ring.  A CTA of three warpgroups walks output tiles
//     of 128 x 256 (persistent: one CTA per SM, tile t, t + grid, ...; the
//     tile's row block varies fastest, so the CTAs running at once share a
//     few w panels in L2).  Warpgroup 0 is the producer: one thread issues,
//     per k slab of 64, the TMA copies of x's 128 x 64 box and w's four 64 x
//     64 boxes (128-byte swizzle; zeros past M, N and K, so the ragged
//     edges need no masks) into a ring of MMW_STAGES stages, each completing
//     on its stage's full mbarrier; the warpgroup gives its registers back
//     (setmaxnreg.dec).  Warpgroups 1 and 2 are the consumers (setmaxnreg.inc),
//     64 rows each: per slab four wgmma.mma_async.m64n256k16 (bf16 in, fp32
//     accumulate in 128 registers a thread), x as the K-major A operand and
//     w, (K, N) row-major as the reference takes it, as the MN-major B
//     operand (the transpose flag 16-bit types allow: no transposed copy of
//     w).  A stage goes back to the producer through its empty mbarrier once
//     the next slab's wgmma group is issued and this one's has completed.
//     The store is masked at M and N, so K % 8 == 0 and N % 8 == 0 (TMA's
//     16-byte row strides); the tensor maps come from hf_matmul.
//   fp32 (mm_f32_kernel): CUDA-core fmaf (no TF32: the reference
//     multiplies in fp32), bound by the FMA rate (67 TFLOP/s), so the design
//     keeps the FMA pipes fed: 128 x 128 tiles, four warps of 64 x 64, each
//     thread 16 x 8 outputs (128 FMAs for 6 float4 shared-memory reads a k;
//     8 x 8 a thread of 256 threads ran slower on the H100), two CTAs an
//     SM;
//     16-deep k slabs through a ring of MMF_STAGES stages by cp.async, two
//     slabs in flight while one is read, one __syncthreads a slab; x lands
//     transposed (one 4-byte copy an element, a warp's copies whole runs of
//     k) so its fragments are float4s like w's; the next k's fragments are
//     read while this k's FMAs run; the CTAs running at once walk groups of
//     MMF_GROUP row blocks, row block fastest, so they share x's and w's
//     panels in L2.  Zeros past M, N and K (the copies' zero fill), stores
//     masked at M and N, so K % 4 == 0 and N % 4 == 0.  Each output's sum is
//     one fmaf chain in k order.
#pragma once

#include "common.cuh"

#define MM_BM 128           // output tile rows (both kernels)
#define MMF_BN 128          // output tile columns of the fp32 kernel
#define MMF_BK 16           // k slab of an fp32 ring stage
#define MMF_STAGES 3        // fp32 ring: two slabs in flight, one read
#define MMF_THREADS 128
#define MMF_GROUP 16        // row blocks of a group of the fp32 tile walk
#define MMF_LDA (MM_BM + 4) // row stride of the transposed x slab (floats)
#define MMF_A_FLOATS (MMF_BK * MMF_LDA)
#define MMF_STAGE_FLOATS (MMF_A_FLOATS + MMF_BK * MMF_BN)
#define MMF_SMEM (MMF_STAGES * MMF_STAGE_FLOATS * 4)  // 49,920 bytes
#define MMW_BN 256          // output tile columns of the bf16 kernel
#define MMW_BK 64           // k slab of the bf16 kernel: 128 bytes of x a row
#define MMW_STAGES 4
#define MMW_THREADS 384     // the producer warpgroup and two consumers
#define MMW_X_BYTES (MM_BM * MMW_BK * 2)      // x box, 16 KB
#define MMW_WBOX_BYTES (MMW_BK * 64 * 2)      // one 64-column w box, 8 KB
#define MMW_STAGE_BYTES (MMW_X_BYTES + 4 * MMW_WBOX_BYTES)
// 1024 bytes of alignment slack | ring | full and empty mbarriers
#define MMW_SMEM (1024 + MMW_STAGES * MMW_STAGE_BYTES + 16 * MMW_STAGES)

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at p
// (1024-byte aligned atoms): lbo / sbo are the byte strides between 64-element
// atoms along MN (MN-major) and between 8-row groups.
__device__ __forceinline__ uint64_t mmw_desc(const void* p, unsigned lbo,
                                             unsigned sbo) {
  return (uint64_t)((hf_saddr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

#define MMW_D8(i)                                                     \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 x 256 fp32, the wgmma accumulator layout) += A (64 x 16, K-major)
// * B (16 x 256, MN-major: imm-trans-b 1)
__device__ __forceinline__ void mmw_mma(float (&d)[128], uint64_t a,
                                        uint64_t b) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
    "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
    "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
    "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
    "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
    "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
    "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
    "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
    "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
    "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,"
    "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
    "%120,%121,%122,%123,%124,%125,%126,%127}, "
    "%128, %129, p, 1, 1, 0, 1;\n}\n"
    : MMW_D8(0), MMW_D8(8), MMW_D8(16), MMW_D8(24), MMW_D8(32), MMW_D8(40),
      MMW_D8(48), MMW_D8(56), MMW_D8(64), MMW_D8(72), MMW_D8(80), MMW_D8(88),
      MMW_D8(96), MMW_D8(104), MMW_D8(112), MMW_D8(120)
    : "l"(a), "l"(b), "r"(1));
}
#undef MMW_D8

// keep the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits
__device__ __forceinline__ void mmw_fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(MMW_THREADS, 1)
    mm_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw, bf16* out, int M,
                   int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (hf_saddr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + MMW_STAGES *
                                               MMW_STAGE_BYTES);
  uint64_t* empty = full + MMW_STAGES;
  const int tiles_m = (M + MM_BM - 1) / MM_BM;
  const int ntiles = tiles_m * ((N + MMW_BN - 1) / MMW_BN);
  const int nk = (K + MMW_BK - 1) / MMW_BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < MMW_STAGES; ++s) {
      hf_bar_init(full + s, 1);
      hf_bar_init(empty + s, 8);     // one arrival per consumer warp
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full across the CTA's tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int m0 = (t % tiles_m) * MM_BM, n0 = (t / tiles_m) * MMW_BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % MMW_STAGES;
          hf_bar_wait(empty + s, ((it / MMW_STAGES) & 1) ^ 1);
          unsigned char* st = ring + s * MMW_STAGE_BYTES;
          hf_bar_expect(full + s, MMW_STAGE_BYTES);
          hf_tma_2d(st, &tx, kb * MMW_BK, m0, full + s);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            hf_tma_2d(st + MMW_X_BYTES + b * MMW_WBOX_BYTES, &tw,
                      n0 + 64 * b, kb * MMW_BK, full + s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // a consumer: rows 64 * (wg - 1).. of each tile
    const int c = wg - 1, t128 = threadIdx.x - 128 * wg;
    const int lane = threadIdx.x & 31;
    const int r0 = 64 * c + 16 * (t128 >> 5) + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    float d[128];
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int m0 = (t % tiles_m) * MM_BM, n0 = (t / tiles_m) * MMW_BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      mmw_fence_acc(d);
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % MMW_STAGES;
        hf_bar_wait(full + s, (it / MMW_STAGES) & 1);
        const unsigned char* st = ring + s * MMW_STAGE_BYTES;
        // A: this warpgroup's 64 rows of x's box (rows of 128 bytes, 8-row
        // groups 1024 bytes apart), +32 bytes a k16 step; B: w's boxes 8 KB
        // apart along N, 8-row groups 1024 bytes apart, +2048 bytes a step
        const uint64_t da = mmw_desc(st + c * 64 * 128, 16, 1024);
        const uint64_t db = mmw_desc(st + MMW_X_BYTES, MMW_WBOX_BYTES, 1024);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < MMW_BK / 16; ++k)
          mmw_mma(d, da + 2 * k, db + 128 * k);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous slab's group has completed: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        mmw_fence_acc(d);
        if (kb > 0 && lane == 0)
          hf_bar_arrive(empty + (it - 1) % MMW_STAGES);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mmw_fence_acc(d);
      if (lane == 0) hf_bar_arrive(empty + (it - 1) % MMW_STAGES);
      // accumulator 4 j + e: row r0 (+8 for e >= 2), columns 8 j + c0 + (e & 1)
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + c0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + r0 + 8 * h;
          if (row < M && col < N)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
                __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(MMF_THREADS, 2)
    mm_f32_kernel(const float* x, const float* w, float* out, int M, int N,
                  int K) {
  extern __shared__ __align__(16) float mmf_smem[];
  // the tile walk: groups of MMF_GROUP row blocks; in a group the row block
  // varies fastest, then the column tile
  const int tiles_m = (M + MM_BM - 1) / MM_BM;
  const int tiles_n = (N + MMF_BN - 1) / MMF_BN;
  const int per_group = MMF_GROUP * tiles_n, g = blockIdx.x / per_group;
  const int in_g = blockIdx.x - g * per_group;
  const int gm = min(MMF_GROUP, tiles_m - g * MMF_GROUP);
  const int m0 = (g * MMF_GROUP + in_g % gm) * MM_BM;
  const int n0 = (in_g / gm) * MMF_BN;

  // four warps, warp w owns the 64 x 64 quarter at rows 64 (w / 2),
  // columns 64 (w % 2); lane l rows 4 (l / 8) + 16 q + {0..3} (q < 4),
  // columns 4 (l % 8) + 32 h + {0..3} (h < 2) of it: 128 outputs a thread,
  // and a warp's fragment reads are 64 contiguous bytes of the x slab and
  // 128 of the w slab, one shared-memory wavefront each
  static_assert(MMF_THREADS == 128, "four warps of 64 x 64");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fr = (warp >> 1) * 64 + (lane >> 3) * 4;
  const int fc = (warp & 1) * 64 + (lane & 7) * 4;
  // loaders: x element (row tid / BK + XR u, k tid % BK), one 4-byte copy
  // each into the transposed slab (a warp's copies: whole runs of k); w's
  // 16-byte chunk (row tid / 32 + WR u, columns 4 (tid % 32)..)
  constexpr int XR = MMF_THREADS / MMF_BK, WR = MMF_THREADS / 32;
  const int xr = tid / MMF_BK, xk = tid % MMF_BK;
  const int wk = tid >> 5, wc = (tid & 31) * 4;
  const float* xsrc = x + (size_t)(m0 + xr) * K + xk;
  const float* wsrc = w + (size_t)wk * N + n0 + wc;
  const bool wcol = n0 + wc < N;
  const int nk = (K + MMF_BK - 1) / MMF_BK;
  auto load = [&](int kt) {
    if (kt < nk) {
      float* As = mmf_smem + (kt % MMF_STAGES) * MMF_STAGE_FLOATS;
      float* Bs = As + MMF_A_FLOATS;
      const int kb = kt * MMF_BK;
#pragma unroll
      for (int u = 0; u < MM_BM / XR; ++u) {
        const bool ok = m0 + xr + XR * u < M && kb + xk < K;
        cp_async4(As + xk * MMF_LDA + xr + XR * u,
                  ok ? xsrc + (size_t)XR * u * K + kb : x, ok);
      }
#pragma unroll
      for (int u = 0; u < MMF_BK / WR; ++u) {
        const bool ok = wcol && kb + wk + WR * u < K;
        cp_async16(Bs + (wk + WR * u) * MMF_BN + wc,
                   ok ? wsrc + (size_t)(kb + WR * u) * N : w, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[16][8];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // the fragments of slab row k, double-buffered: six float4 reads
  float4 a[2][4], b[2][2];
  auto frag = [&](const float* As, const float* Bs, int k, float4* fa,
                  float4* fb) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      fa[q] = *reinterpret_cast<const float4*>(As + k * MMF_LDA + fr + 16 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fb[h] = *reinterpret_cast<const float4*>(Bs + k * MMF_BN + fc + 32 * h);
  };

#pragma unroll
  for (int s = 0; s < MMF_STAGES - 1; ++s) load(s);
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(MMF_STAGES - 2));
    __syncthreads();               // slab kt has landed; kt - 1 is free
    load(kt + MMF_STAGES - 1);
    const float* As = mmf_smem + (kt % MMF_STAGES) * MMF_STAGE_FLOATS;
    const float* Bs = As + MMF_A_FLOATS;
    frag(As, Bs, 0, a[0], b[0]);
#pragma unroll
    for (int k = 0; k < MMF_BK; ++k) {
      // the next k's fragments in flight while this k's FMAs run
      if (k + 1 < MMF_BK) frag(As, Bs, k + 1, a[(k + 1) & 1], b[(k + 1) & 1]);
      const float4* A = a[k & 1];
      const float4* B = b[k & 1];
      const float av[16] = {A[0].x, A[0].y, A[0].z, A[0].w, A[1].x, A[1].y,
                            A[1].z, A[1].w, A[2].x, A[2].y, A[2].z, A[2].w,
                            A[3].x, A[3].y, A[3].z, A[3].w};
      const float bv[8] = {B[0].x, B[0].y, B[0].z, B[0].w,
                           B[1].x, B[1].y, B[1].z, B[1].w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // acc[i][j]: row fr + 16 (i / 4) + i % 4, column fc + 32 (j / 4) + j % 4
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = m0 + fr + 16 * (i >> 2) + (i & 3);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + fc + 32 * h;
      if (col < N)
        *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued), or
// -1 when the tensor-map encoder cannot be found, or a CUresult + 1000 when
// it refuses a map.
int hf_matmul(const void* x, const void* w, void* out, int M, int N, int K,
              int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    static int granted_f32 = 48 * 1024;
    int e = hf_allow_kernel_smem(mm_f32_kernel, MMF_SMEM, &granted_f32);
    if (e) return e;
    const int grid = ((M + MM_BM - 1) / MM_BM) * ((N + MMF_BN - 1) / MMF_BN);
    mm_f32_kernel<<<grid, MMF_THREADS, MMF_SMEM, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
  // x (M, K): boxes of 64 k x 128 rows; w (K, N): boxes of 64 columns x 64
  // k rows; both 128-byte swizzled, zeros out of bounds
  CUtensorMap tx, tw;
  int e = hf_tmap_2d(&tx, x, K, M, MMW_BK, MM_BM);
  if (!e) e = hf_tmap_2d(&tw, w, N, K, 64, MMW_BK);
  if (e) return e;
  static int granted = 48 * 1024;
  e = hf_allow_kernel_smem(mm_bf16_kernel, MMW_SMEM, &granted);
  if (e) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ntiles = ((M + MM_BM - 1) / MM_BM) * ((N + MMW_BN - 1) / MMW_BN);
  mm_bf16_kernel<<<ntiles < sms ? ntiles : sms, MMW_THREADS, MMW_SMEM, s>>>(
      tx, tw, static_cast<bf16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per CTA of the tiled matmul's kernel for the type
int hf_matmul_smem(int fp32) { return fp32 ? MMF_SMEM : MMW_SMEM; }

}  // extern "C"
