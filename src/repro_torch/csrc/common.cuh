// Shared definitions of the bundle launcher and its members (sm_90a).
//
// A member descriptor travels by value inside the launch's parameter block
// (BundleDesc, read through __grid_constant__, so indexing it costs no local
// copy).  Its layout is mirrored by ctypes structures in
// src/repro_torch/kernels/cuda.py; hf_desc_sizes() lets Python check that the
// two agree before the first launch.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (declarations only)
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HF_MAX_MEMBERS 8
#define HF_THREADS 256
#define HF_WARPS (HF_THREADS / 32)
#define HF_NEG_INF (-1e30f)

// member kinds
enum { HF_ROW = 1, HF_DECODE_ATTN = 2, HF_PREFILL_ATTN = 3, HF_ADAMW = 4,
       HF_MAXPOOL = 5, HF_UPSAMPLE = 6, HF_BNSTATS = 7, HF_IM2COL = 8,
       HF_HIST = 9, HF_ETHASH = 10, HF_HASH = 11, HF_MOE_GMM = 12 };

struct MemberDesc {
  int kind, ctas, ratio, offset;
  int i[16];
  float f[8];   // baked float parameters (AdamW: b1, 1-b1, b2, 1-b2, eps, wd;
                //   hist: bins / 8; a row chain's RMSNorm eps: f[6])
  const void* in[6];
  void* out[4];
};

struct BundleDesc {
  int n, period;
  MemberDesc m[HF_MAX_MEMBERS];
};

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
// round an fp32 value to bf16 and back: what a bf16 store then load gives
__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// one element of a kernel templated on its I/O type (bf16 or fp32) to fp32
// and back; the bf16 forms are bf2f and f2bf
__device__ __forceinline__ float to_f32(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return f2bf(v);
}
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// eight bf16 values packed in a 16-byte vector -> fp32
__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Tensor-core and async-copy helpers (the tiled matmul and the attention
// tile loop of attention_mma.cuh)

// one 16-byte global -> shared copy, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes).  Lane t receives, in
// r[i], row t / 4, columns 2 * (t % 4) and + 1 of matrix i (the mma operand
// layout); with .trans, rows 2 * (t % 4) and + 1 of column t / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// mbarriers and TMA copies (the grouped expert FFN's weight ring, the bf16
// tiled matmul's operand ring)
__device__ __forceinline__ unsigned hf_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// one 4-byte global -> shared copy (through L1), zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hf_saddr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// a barrier whose phase completes after `count` arrivals (and the bytes
// announced by hf_bar_expect)
__device__ __forceinline__ void hf_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
      hf_saddr(bar)), "r"(count));
}
// one arrival of the phase, expecting `bytes` from TMA copies
__device__ __forceinline__ void hf_bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(hf_saddr(bar)), "r"(bytes) : "memory");
}
// one arrival of the phase
__device__ __forceinline__ void hf_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
      hf_saddr(bar)) : "memory");
}
// wait for the phase of the given parity; a phase that never completes
// traps (an error at the next synchronisation) instead of hanging the card
__device__ __forceinline__ void hf_bar_wait(uint64_t* bar, int parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(hf_saddr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (n > (1u << 26)) __trap();
  }
}
// 2-D TMA box at (c0 inner, c1 outer) of `map` (a __grid_constant__ kernel
// parameter or a map in device memory) into dst, completing on bar
__device__ __forceinline__ void hf_tma_2d(void* dst, const void* map, int c0,
                                          int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(hf_saddr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(hf_saddr(bar))
      : "memory");
}

// The TMA tensor-map encoder, cuTensorMapEncodeTiled, looked up in the
// already loaded libcuda (the library is not linked against it); null when
// it cannot be found.
typedef CUresult (*HfTmapEncode)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
static HfTmapEncode hf_tmap_encoder() {
  static HfTmapEncode encode = nullptr;
  if (!encode) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib)
      encode = reinterpret_cast<HfTmapEncode>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return encode;
}

// A 2-D tensor map of a row-major bf16 matrix (outer rows of inner
// elements), boxes of box_inner x box_outer, 128-byte swizzle, zeros out of
// bounds.  Returns 0, -1 without an encoder, or 1000 + the CUresult.
static int hf_tmap_2d(CUtensorMap* map, const void* p, int inner, int outer,
                      int box_inner, int box_outer) {
  const HfTmapEncode encode = hf_tmap_encoder();
  if (!encode) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

__host__ __device__ __forceinline__ int hf_align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Allow `kernel` `smem` bytes of dynamic shared memory per CTA (above 48 KB
// only after this opt-in); `granted` caches the largest size allowed so far.
// Returns the cudaError_t (0 = allowed).
template <typename Kernel>
static int hf_allow_kernel_smem(Kernel* kernel, int smem, int* granted) {
  if (smem <= *granted) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  *granted = smem;
  return 0;
}

// The last-CTA combine of a member whose CTAs each write a partial into a
// per-launch workspace: after this CTA's partial is in device memory, take a
// ticket of `group`; true in every thread of the CTA that drew the last.
// No CTA waits for another, so a launch with more CTAs than fit on the card
// cannot deadlock.
__device__ __forceinline__ bool hf_last_of_group(int* tickets, int group,
                                                 int members) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + group, 1) == members - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}
