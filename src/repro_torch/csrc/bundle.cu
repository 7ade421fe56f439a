// Bundle launcher: N fusible members as ONE kernel launch (the paper's
// horizontal fusion, CTA-level partition).
//
// Replaces the TPU kernels src/repro/core/hfuse.py:87 (generate, with the
// phase functions of _bundle_phase_fns, :41-72), :152 (generate_vfused) and
// :161 (run_single, a one-member bundle with ratio 1).
//
// Partition: within a super-step of `period` CTAs, member i owns the phase
// window [off_i, off_i + r_i).  CTA t computes s = t / period and
// ph = t % period, finds the member whose window holds ph, and runs that
// member's local CTA s * r_i + ph - off_i, or exits at once when that is
// past the member's CTA count.  This is _bundle_phase_fns' step formula,
// applied to CTAs instead of TPU grid steps; the grid is
// max_i ceil(ctas_i / r_i) * period.  Python mirrors the same table
// (repro_torch/core/hfuse.py phase_table) so the CPU tests check it.
//
// Bound on the card: whatever its members are; the point of the launch is
// that a memory-bound member (decode attention, a weight stream) and a
// compute-bound one (chunk prefill attention) share the SMs at the same
// time.  All members share one blockDim (HF_THREADS); the dynamic shared
// memory is the largest any member needs.  A warp-level partition with named
// barriers (the paper's Fig. 5) is later work.
//
// The library also holds the two standalone kernels the reference never
// fuses (they are not OpSpecs): the tiled matmul (tiled_matmul.cuh) and flash
// attention (flash_attention.cuh: an fp32 kernel and a bf16 tensor-core one
// per head-dim class), each its own __global__ kernel with its own launch
// bounds and launcher, so none weighs on this kernel's registers.  The
// prefill attention member runs the same tensor-core tile loop
// (attention_mma.cuh) as a non-inlined call.
//
// Two instances of the kernel: hf_bundle<true> holds the row family's chain
// bodies (csrc/row_member.cuh: ROW_CHAIN, the GEMM's EPI_* epilogues, the
// fp32 GEMM's staged producer) and runs every launch that carries one;
// hf_bundle<false> runs all other launches.  Compiled into the one kernel,
// the chain code moved ptxas's allocation of every member and slowed the
// serve members 1.6-3.2% on the H100; the other instance keeps them as they
// were.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (src/repro_torch/kernels/cuda.py builds it at first use).
#include "common.cuh"
#include "adamw_member.cuh"
#include "decode_attention.cuh"
#include "flash_attention.cuh"
#include "moe_gmm_member.cuh"
#include "paper_member.cuh"
#include "prefill_attention.cuh"
#include "row_member.cuh"
#include "tiled_matmul.cuh"

// At least two CTAs per SM: ptxas keeps every member within 128 registers a
// thread, so no member's register appetite halves the others' occupancy.
template <bool CHAINS>
__global__ void __launch_bounds__(HF_THREADS, 2)
    hf_bundle(const __grid_constant__ BundleDesc b) {
  const int t = blockIdx.x;
  const int s = t / b.period, ph = t % b.period;
  for (int i = 0; i < b.n; ++i) {
    const MemberDesc& m = b.m[i];
    if (ph < m.offset || ph >= m.offset + m.ratio) continue;
    const int local = s * m.ratio + ph - m.offset;
    if (local >= m.ctas) return;
    switch (m.kind) {
      case HF_ROW: row_member<CHAINS>(m, local); break;
      case HF_DECODE_ATTN: decode_attn_member(m, local); break;
      case HF_PREFILL_ATTN: prefill_attn_member(m, local); break;
      case HF_ADAMW: adamw_member(m, local); break;
      case HF_MAXPOOL: maxpool_member(m, local); break;
      case HF_UPSAMPLE: upsample_member(m, local); break;
      case HF_BNSTATS: bnstats_member(m, local); break;
      case HF_IM2COL: im2col_member(m, local); break;
      case HF_HIST: hist_member(m, local); break;
      case HF_ETHASH: ethash_member(m, local); break;
      case HF_HASH: hash_member(m, local); break;
      case HF_MOE_GMM: moe_gmm_member(m, local); break;
      default: break;
    }
    return;
  }
}

// Allow `smem` bytes of dynamic shared memory per CTA of one instance
// (0 = allowed).
template <bool CHAINS>
static int hf_allow_smem(int smem) {
  static int granted = 48 * 1024;
  return hf_allow_kernel_smem(hf_bundle<CHAINS>, smem, &granted);
}

static bool hf_needs_chains(const BundleDesc& b) {
  for (int i = 0; i < b.n; ++i)
    if (b.m[i].kind == HF_ROW && row_chain_kernel(b.m[i])) return true;
  return false;
}

extern "C" {

int hf_desc_sizes(int* member, int* bundle) {
  *member = (int)sizeof(MemberDesc);
  *bundle = (int)sizeof(BundleDesc);
  return HF_THREADS;
}

int hf_member_smem(const MemberDesc* m) {
  switch (m->kind) {
    case HF_ROW: return row_smem_bytes(*m);
    case HF_DECODE_ATTN: return decode_attn_smem_bytes(*m);
    case HF_PREFILL_ATTN: return prefill_attn_smem_bytes(*m);
    case HF_ADAMW: return adamw_smem_bytes(*m);
    case HF_MAXPOOL:
    case HF_UPSAMPLE:
    case HF_BNSTATS:
    case HF_IM2COL:
    case HF_HIST:
    case HF_ETHASH:
    case HF_HASH: return paper_smem_bytes(*m);
    case HF_MOE_GMM: return gmm_smem_bytes(*m);
    default: return -1;
  }
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int hf_launch(const BundleDesc* b, int grid, int smem, void* stream) {
  const bool chains = hf_needs_chains(*b);
  int e = chains ? hf_allow_smem<true>(smem) : hf_allow_smem<false>(smem);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains)
    hf_bundle<true><<<grid, HF_THREADS, smem, s>>>(*b);
  else
    hf_bundle<false><<<grid, HF_THREADS, smem, s>>>(*b);
  return (int)cudaGetLastError();
}

// CTAs of a launch with `smem` bytes of dynamic shared memory that fit on
// one SM at once (registers, shared memory and threads counted; the fewer
// of the two instances); returns the cudaError_t.
int hf_occupancy(int smem, int* ctas_per_sm) {
  int e = hf_allow_smem<false>(smem);
  if (!e) e = hf_allow_smem<true>(smem);
  if (e) return e;
  int a = 0, c = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a, hf_bundle<false>, HF_THREADS, smem);
  if (!e)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c, hf_bundle<true>, HF_THREADS, smem);
  *ctas_per_sm = a < c ? a : c;
  return e;
}

const char* hf_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
