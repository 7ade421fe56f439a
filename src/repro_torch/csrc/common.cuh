// Shared definitions of the bundle launcher and its members (sm_90a).
//
// A member descriptor travels by value inside the launch's parameter block
// (BundleDesc, read through __grid_constant__, so indexing it costs no local
// copy).  Its layout is mirrored by ctypes structures in
// src/repro_torch/kernels/cuda.py; hf_desc_sizes() lets Python check that the
// two agree before the first launch.
#pragma once

#include <cuda_bf16.h>
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
  void* out[3];
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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
