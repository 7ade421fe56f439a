// AdamW member: the per-tensor optimizer update over one flat (R, 128) leaf.
//
// Replaces the TPU kernels src/repro/kernels/adam.py:67 (adamw_op), :42
// (adamw_flat, a one-member launch of it) and :117 (multi_tensor_adamw, an
// N-way bundle of it).  Computes what _adam_kernel (adam.py:27-39) computes,
// in the same operation order, in fp32:
//   m = b1*m + (1-b1)*g;  v = b2*v + ((1-b2)*g)*g
//   p = p - lr * ((m/bc1) / (sqrt(v/bc2) + eps) + wd*p)
// with lr, bc1, bc2 from the (1, 128) fp32 scalars operand and b1, 1-b1, b2,
// 1-b2, eps, wd baked into the descriptor (1-b1 and 1-b2 rounded from double
// on the host, as a Python scalar reaches an fp32 tensor op).  Every product,
// sum, quotient and root is a round-to-nearest intrinsic, so nothing is
// contracted into an FMA or approximated whatever the flags: the member is
// bitwise equal to the plain PyTorch version, op for op.
//
// Bound on the card: bytes.  22 bytes move per bf16 parameter (read p 2, g 2,
// m 4, v 4; write p 2, m 4, v 4) for about a dozen flops, far below the
// H100's ~295 flop/byte ridge.  Design: one CTA per (bm, 128) block, 256
// threads grid-striding over it with 16-byte vector loads and stores (8 bf16
// or 4 fp32 values), no shared memory.  p, m and v may be written in place
// (the output pointers equal the input pointers): each element is read, then
// written, by the same thread, and no pointer is declared __restrict__.
//
// Descriptor: i[0] = R, i[1] = bm (rows per CTA), i[2] = p/g dtype
// (0 bf16, 1 fp32); f[0..5] = b1, 1-b1, b2, 1-b2, eps, wd;
// in = {scalars, p, g, m, v}, out = {p, m, v}.
//
// adamw_update is the update of one element; the member and the row
// chains that end in an AdamW update (csrc/row_member.cuh: the dW GEMM's
// epilogue, a row-wise producer's stage) all call it, so a chain's update
// is the member's, bit for bit.
#pragma once

#include "common.cuh"

#define ADAMW_LANES 128

// lr, bc1, bc2 from the (1, 128) scalars operand; the rest from f[0..5]
struct AdamwK {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ AdamwK adamw_consts(const MemberDesc& md,
                                               const float* sc) {
  return {sc[0], sc[1], sc[2], md.f[0], md.f[1], md.f[2], md.f[3], md.f[4],
          md.f[5]};
}

// _adam_kernel's update of one element, in its operation order
__device__ __forceinline__ void adamw_update(const AdamwK& k, float& p,
                                             float g, float& m, float& v) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), k.eps);
  const float step = __fadd_rn(__fdiv_rn(__fdiv_rn(m, k.bc1), den),
                               __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(k.lr, step));
}

// element e of p (T), m, v (fp32) updated in place with gradient g
template <typename T>
__device__ __forceinline__ void adamw_elem(const AdamwK& k, T* p, float* m,
                                           float* v, size_t e, float g) {
  float pv = to_f32(p[e]), mv = m[e], vv = v[e];
  adamw_update(k, pv, g, mv, vv);
  p[e] = from_f32<T>(pv);
  m[e] = mv;
  v[e] = vv;
}

__device__ __forceinline__ void adamw_load8(const bf16* src, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(src), f);
}

__device__ __forceinline__ void adamw_load8(const float* src, float* f) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void adamw_store8(bf16* dst, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void adamw_store8(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T>
__device__ __forceinline__ void adamw_block(const MemberDesc& md, size_t base,
                                            size_t n) {
  const AdamwK k = adamw_consts(md, static_cast<const float*>(md.in[0]));
  const T* p_in = static_cast<const T*>(md.in[1]) + base;
  const T* g_in = static_cast<const T*>(md.in[2]) + base;
  const float* m_in = static_cast<const float*>(md.in[3]) + base;
  const float* v_in = static_cast<const float*>(md.in[4]) + base;
  T* p_out = static_cast<T*>(md.out[0]) + base;
  float* m_out = static_cast<float*>(md.out[1]) + base;
  float* v_out = static_cast<float*>(md.out[2]) + base;
  for (size_t e = (size_t)threadIdx.x * 8; e < n; e += (size_t)HF_THREADS * 8) {
    float p[8], g[8], m[8], v[8];
    adamw_load8(p_in + e, p);
    adamw_load8(g_in + e, g);
    adamw_load8(m_in + e, m);
    adamw_load8(v_in + e, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) adamw_update(k, p[j], g[j], m[j], v[j]);
    adamw_store8(p_out + e, p);
    adamw_store8(m_out + e, m);
    adamw_store8(v_out + e, v);
  }
}

__device__ __forceinline__ void adamw_member(const MemberDesc& md, int local) {
  const size_t n = (size_t)md.i[1] * ADAMW_LANES;
  const size_t base = (size_t)local * n;
  if (md.i[2] == 0) {
    adamw_block<bf16>(md, base, n);
  } else {
    adamw_block<float>(md, base, n);
  }
}

__host__ __device__ inline int adamw_smem_bytes(const MemberDesc&) { return 0; }
