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
// Instances of the kernel.  ptxas allocates each kernel as a whole, so code
// compiled into it for one member moves every other member's allocation (1-5%
// either way on the H100: PERF.md).  So a launch runs the narrowest instance
// that holds its members:
//   hf_rows<false>   row members only (the GEMM, RMSNorm, activation,
//                    residual add, no chain),
//   hf_rows<true>    row members of which one needs a chain body
//                    (csrc/row_member.cuh row_chain_kernel: ROW_CHAIN, the
//                    GEMM's EPI_* epilogues, the fp32 GEMM's staged producer),
//   hf_paper         the paper suite's members only,
//   hf_stream        one maxpool member alone: its body only, up to 64
//                    registers (4 CTAs an SM, so maxpool's 512 CTAs run in
//                    one wave; hf_paper's 127 registers hold a launch to two
//                    CTAs an SM).  On the H100 maxpool runs 0.6 us faster
//                    here than in hf_paper in fp32, 1.0-1.9 us in bf16
//                    (scripts/member_variants.py no_stream; PERF.md §6),
//   hf_bundle<false> / <true>  any other mix (every member kind; <true>
//                    when a row member needs a chain body).
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

// kinds as bits, and the sets an instance holds
#define HF_KIND(k) (1u << (k))
#define HF_KINDS_ROW HF_KIND(HF_ROW)
#define HF_KINDS_PAPER                                                   \
  (HF_KIND(HF_MAXPOOL) | HF_KIND(HF_UPSAMPLE) | HF_KIND(HF_BNSTATS) |    \
   HF_KIND(HF_IM2COL) | HF_KIND(HF_HIST) | HF_KIND(HF_ETHASH) |          \
   HF_KIND(HF_HASH))
#define HF_KINDS_STREAM HF_KIND(HF_MAXPOOL)
#define HF_KINDS_ALL                                                     \
  (HF_KINDS_ROW | HF_KINDS_PAPER | HF_KIND(HF_DECODE_ATTN) |             \
   HF_KIND(HF_PREFILL_ATTN) | HF_KIND(HF_ADAMW) | HF_KIND(HF_MOE_GMM))

// The body of every instance: the member kinds outside KINDS are not
// compiled in (the host never sends them there).
#define HF_CASE(k, call)                   \
  case k:                                  \
    if (KINDS & HF_KIND(k)) call(m, local); \
    break

template <bool CHAINS, unsigned KINDS>
__device__ __forceinline__ void hf_run(const BundleDesc& b) {
  const int t = blockIdx.x;
  const int s = t / b.period, ph = t % b.period;
  for (int i = 0; i < b.n; ++i) {
    const MemberDesc& m = b.m[i];
    if (ph < m.offset || ph >= m.offset + m.ratio) continue;
    const int local = s * m.ratio + ph - m.offset;
    if (local >= m.ctas) return;
    switch (m.kind) {
      HF_CASE(HF_ROW, row_member<CHAINS>);
      HF_CASE(HF_DECODE_ATTN, decode_attn_member);
      HF_CASE(HF_PREFILL_ATTN, prefill_attn_member);
      HF_CASE(HF_ADAMW, adamw_member);
      HF_CASE(HF_MAXPOOL, maxpool_member);
      HF_CASE(HF_UPSAMPLE, upsample_member);
      HF_CASE(HF_BNSTATS, bnstats_member);
      HF_CASE(HF_IM2COL, im2col_member);
      HF_CASE(HF_HIST, hist_member);
      HF_CASE(HF_ETHASH, ethash_member);
      HF_CASE(HF_HASH, hash_member);
      HF_CASE(HF_MOE_GMM, moe_gmm_member);
      default: break;
    }
    return;
  }
}

// At least two CTAs per SM: ptxas keeps every member within 128 registers a
// thread, so no member's register appetite halves the others' occupancy.
template <bool CHAINS>
__global__ void __launch_bounds__(HF_THREADS, 2)
    hf_bundle(const __grid_constant__ BundleDesc b) {
  hf_run<CHAINS, HF_KINDS_ALL>(b);
}
template <bool CHAINS>
__global__ void __launch_bounds__(HF_THREADS, 2)
    hf_rows(const __grid_constant__ BundleDesc b) {
  hf_run<CHAINS, HF_KINDS_ROW>(b);
}
__global__ void __launch_bounds__(HF_THREADS, 2)
    hf_paper(const __grid_constant__ BundleDesc b) {
  hf_run<false, HF_KINDS_PAPER>(b);
}
__global__ void __launch_bounds__(HF_THREADS, 4)
    hf_stream(const __grid_constant__ BundleDesc b) {
  hf_run<false, HF_KINDS_STREAM>(b);
}

typedef void (*HfKernel)(BundleDesc);
enum { HF_I_MIXED, HF_I_MIXED_CHAINS, HF_I_ROWS, HF_I_ROWS_CHAINS, HF_I_PAPER,
       HF_I_STREAM, HF_INSTANCES };
static const HfKernel hf_instances[HF_INSTANCES] = {
    hf_bundle<false>, hf_bundle<true>, hf_rows<false>, hf_rows<true>,
    hf_paper, hf_stream};
static const char* const hf_instance_names[HF_INSTANCES] = {
    "hf_bundle<false>", "hf_bundle<true>", "hf_rows<false>", "hf_rows<true>",
    "hf_paper", "hf_stream"};

// Allow `smem` bytes of dynamic shared memory per CTA of instance `inst`
// (0 = allowed).
static int hf_allow_smem(int inst, int smem) {
  static int granted[HF_INSTANCES] = {48 * 1024, 48 * 1024, 48 * 1024,
                                      48 * 1024, 48 * 1024, 48 * 1024};
  return hf_allow_kernel_smem(hf_instances[inst], smem, &granted[inst]);
}

// The narrowest instance that holds every member of the launch (a fused
// paper launch stays in hf_paper).
static int hf_instance(const BundleDesc& b) {
  unsigned kinds = 0;
  bool chains = false;
  for (int i = 0; i < b.n; ++i) {
    kinds |= HF_KIND(b.m[i].kind);
    chains = chains || (b.m[i].kind == HF_ROW && row_chain_kernel(b.m[i]));
  }
  if (!(kinds & ~HF_KINDS_ROW))
    return chains ? HF_I_ROWS_CHAINS : HF_I_ROWS;
  if (b.n == 1 && !(kinds & ~HF_KINDS_STREAM)) return HF_I_STREAM;
  if (!(kinds & ~HF_KINDS_PAPER)) return HF_I_PAPER;
  return chains ? HF_I_MIXED_CHAINS : HF_I_MIXED;
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
  const int inst = hf_instance(*b);
  int e = hf_allow_smem(inst, smem);
  if (e) return e;
  hf_instances[inst]<<<grid, HF_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(*b);
  return (int)cudaGetLastError();
}

// CTAs of instance `inst` with `smem` bytes of dynamic shared memory that
// fit on one SM at once (registers, shared memory and threads counted);
// returns the cudaError_t.
static int hf_instance_occupancy(int inst, int smem, int* ctas_per_sm) {
  int e = hf_allow_smem(inst, smem);
  if (!e)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, hf_instances[inst], HF_THREADS, smem);
  return e;
}

// The same for a launch with `smem` bytes: the fewest of the instances.
int hf_occupancy(int smem, int* ctas_per_sm) {
  int fewest = 1 << 30;
  for (int inst = 0; inst < HF_INSTANCES; ++inst) {
    int n = 0, e = hf_instance_occupancy(inst, smem, &n);
    if (e) return e;
    fewest = n < fewest ? n : fewest;
  }
  *ctas_per_sm = fewest;
  return 0;
}

// The instance hf_launch runs for `b` (its name into `name`), and its CTAs
// an SM at `smem` bytes; returns the cudaError_t.
int hf_launch_instance(const BundleDesc* b, int smem, const char** name,
                       int* ctas_per_sm) {
  const int inst = hf_instance(*b);
  *name = hf_instance_names[inst];
  return hf_instance_occupancy(inst, smem, ctas_per_sm);
}

// The grouped expert FFN's two TMA tensor maps (CUtensorMap, 128 bytes
// each, into `out`, 64-byte aligned): w_in (E, d, fin) and w_out (E, f, d)
// bf16, boxes of 32 rows x 64 columns, 128-byte swizzle, zeros out of
// bounds (common.cuh hf_tmap_encoder).  Returns 0, a CUresult, or -1 when
// the encoder cannot be found.
int hf_gmm_tmaps(void* out, const void* w_in, const void* w_out, int E, int d,
                 int f, int fin) {
  const HfTmapEncode encode = hf_tmap_encoder();
  if (!encode) return -1;
  CUtensorMap* maps = static_cast<CUtensorMap*>(out);
  const cuuint32_t box[3] = {64, GMM_KT, 1}, one[3] = {1, 1, 1};
  const cuuint64_t din[3] = {(cuuint64_t)fin, (cuuint64_t)d, (cuuint64_t)E};
  const cuuint64_t st_in[2] = {(cuuint64_t)fin * 2, (cuuint64_t)d * fin * 2};
  const cuuint64_t dout[3] = {(cuuint64_t)d, (cuuint64_t)f, (cuuint64_t)E};
  const cuuint64_t st_out[2] = {(cuuint64_t)d * 2, (cuuint64_t)f * d * 2};
  CUresult r = encode(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(w_in), din, st_in, box, one,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  return (int)encode(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                     const_cast<void*>(w_out), dout, st_out, box, one,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

const char* hf_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
