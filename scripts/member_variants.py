#!/usr/bin/env python3
"""The paper suite's members on the card, as they are and in source
variants, at the paper suite's defaults.

  python3 scripts/member_variants.py [--variants loop_only,no_tanh,...]
      [--cases hist,maxpool_bf16,maxpool_produced,upsample_consumed,launch,...]
      [--rounds N]

For the tree as it is (first and last) and for each variant built from a
patched copy of ``src/repro_torch`` under ``build/member_variants/<name>/``
(all libraries built at once, then one process each, in turn; with
``--rounds N`` the tree and the variants take N turns each, interleaved,
before the tree's last): ptxas's
registers and spills of the hash and ethash bodies, ``hf_paper`` and
``hf_stream``; sha, blake and blake2b (4096 x 128 fp32, 16 / 24 / 20
rounds), ethash_like, bnstats, hist, maxpool, upsample and im2col (fp32 and
bf16) at their defaults, and bnstats at SMALL_KW (its fixed cost): time
(median of 20,
CUDA events, L2 flushed by zeroing a 256 MB buffer as ``core/timing.py``
does; again after a flush that reads it, which leaves L2 full of clean
lines instead of dirty ones, and warm, with no flush; a case ending in
``_produced`` times the member after a producer, ``x.copy_(src)``, that
writes its input just before it, as a layer's output is written before the
next layer reads it: the pair and the copy alone, after a zeroing flush and
warm, and their difference; ``upsample_consumed`` times upsample followed by
maxpool on its output, as a next layer reads it (maxpool(upsample(x)) is x:
checked): the pair and maxpool alone on a stored output, after a zeroing
flush and warm), microseconds a round, share of the bound (the hash kernels' fp32
operations, ethash_like's three TF32 products, bnstats' and hist's bytes)
and max |err| against the plain version; the SM clock and power draw under
blake_like.

Variants (no_tanh, no_combine, loop_only, ethash_no_tanh,
bnstats_no_combine, hist_no_combine and empty_body give wrong outputs: they
time what a part costs):
  eighths      the hash body with 16-deep k groups (eighths), 4 columns a
               lane, 16 rows a step, 4 rows at once: half the state bytes a
               fmaf, twice the partials
  no_tanh      the hash body without tanhf in its combine
  no_combine   the hash body without its combine, barriers kept
  loop_only    the hash body's loop alone: no combine, no barriers
  ethash_cvt   the ethash body's TF32 split by cvt.rna.tf32.f32 instead of
               integer operations
  ethash_trunc the ethash body's high part truncated (one AND), not rounded
  ethash_no_tanh  the ethash body without tanhf
  ethash_no_split  the ethash body's three products on the raw fp32 bits
               (no split arithmetic: what the split costs)
  ethash_one_product  the ethash body's hi.hi product alone (what the
               tensor cores cost)
  ethash_2acc  the ethash body's cross products into a second accumulator
               (twice the independent mma chains)
  ethash_unroll8  the ethash body's k loop unrolled whole (8 groups of 16)
  ethash_256   ethash_like at 256 CTAs (16 runs of 8 blocks a slice: two
               CTAs an SM)
  bnstats_unroll16  bnstats with 16 loads in flight a thread
  bnstats_no_combine  bnstats without its two combine levels
  bnstats_tail16  bnstats' combine levels with 16 loads in flight a thread
  bnstats_4    bnstats at 4 CTAs a grid step (128 CTAs of 128 rows)
  bnstats_16   bnstats at 16 CTAs a grid step (512 CTAs of 32 rows)
  maxpool_cached  maxpool's loads and stores without the streaming hint
               (ld.global.cs / st.global.cs: evict first)
  maxpool_ld_cs  maxpool's loads with the streaming hint, its stores without
  maxpool_st_cs  maxpool's stores with the streaming hint, its loads without
  hist_cached  hist's loads without the streaming hint
  maxpool_policy  maxpool's loads evict-first in L2 by an access policy
               (createpolicy + ld.global.L2::cache_hint) instead of
               ld.global.cs
  hist_no_combine  hist without its last-CTA combine (wrong output: what
               the ticket and the combine cost)
  hist_2 / hist_8  hist at 2 / 8 CTAs a grid step (64 / 256 CTAs)
  no_stream    one-member maxpool launches in hf_paper instead of the
               narrow instance hf_stream
  hist_stream  one-member hist launches in hf_stream too
  maxpool_8    maxpool at 8 CTAs a grid step (256 CTAs of 32 rows: one
               wave at two CTAs an SM)
  empty_body   the maxpool body returns at once: what an hf_paper launch
               costs with its dispatch and no work (the launch cases'
               maxpool at 512 and 64 CTAs)
  own_kernels  beside hf_paper, kernels of the script's own (built only in
               this copy): an empty __global__ without parameters and one
               taking the bundle's 1.5 KB descriptor, at 512 and 64 CTAs,
               and the maxpool and hist bodies each in a __global__ of its
               own (their own register allocation, no member dispatch)
  upsample_tma upsample by the TMA unit: one cp.async.bulk brings the CTA's
               rows (32 KB fp32) into shared memory on an mbarrier, and bulk
               stores (cp.async.bulk.global.shared::cta) write each row
               twice; one warp issues them, the others exit
  upsample_ld_cs / upsample_st_cs  upsample's loads / stores with the
               streaming hint (ld.global.cs / st.global.cs: evict first)
  upsample_stream  one-member upsample launches in the narrow instance
               hf_stream (64 registers, 4 CTAs an SM) instead of hf_paper
  im2col_staged  im2col with its CTA's rows staged in shared memory once
               (cp.async), each 16-byte output vector assembled from two
               aligned shared loads by funnel shifts, block by block, 8
               stores a thread at once (the redesign the ranking did not
               take: torch.index_select is slower than im2col as it is)

The launch cases (``--cases launch``) take a paper launch's fixed cost
apart: maxpool at its defaults (512 CTAs) and at 1024 rows (64 CTAs), hist
at its defaults, an empty event window, and in ``own_kernels`` its kernels;
each timed after a zeroing flush (``core/timing.py``), after a reading
flush and warm (no flush: code, descriptor and data may sit in L2).

Needs the card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import flushed_ms  # noqa: E402  (the reading-flush timer)
_PM = "csrc/paper_member.cuh"
_TANH4 = ("            make_float4(tanhf(a.x), tanhf(a.y), tanhf(a.z), "
          "tanhf(a.w));")
_NO_COMBINE = ("      for (int u = 0; u < RV / HF_THREADS; ++u) {",
               "      for (int u = 0; u < 0; ++u) {")


# own_kernels: kernels of this script's own, appended to csrc/bundle.cu
_OWN = """
__global__ void mv_empty() {}
__global__ void mv_empty_desc(const __grid_constant__ BundleDesc b) {}
__global__ void __launch_bounds__(HF_THREADS, 2)
    mv_maxpool(const __grid_constant__ MemberDesc m) {
  maxpool_member(m, blockIdx.x);
}
__global__ void __launch_bounds__(HF_THREADS, 2)
    mv_hist(const __grid_constant__ MemberDesc m) {
  hist_member(m, blockIdx.x);
}
extern "C" int mv_launch(int which, const BundleDesc* b, int grid, int smem,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: mv_empty<<<grid, HF_THREADS, 0, s>>>(); break;
    case 1: mv_empty_desc<<<grid, HF_THREADS, 0, s>>>(*b); break;
    case 2: mv_maxpool<<<grid, HF_THREADS, smem, s>>>(b->m[0]); break;
    default: mv_hist<<<grid, HF_THREADS, smem, s>>>(b->m[0]); break;
  }
  return (int)cudaGetLastError();
}
"""


# maxpool_policy: a 16-byte load whose L2 line is evict-first by an access
# policy (createpolicy), leaving L1 and the hit path as they are
_POLICY_LD = """__device__ __forceinline__ uint4 ps_ld_ef(const uint4* p) {
  uint4 r;
  asm volatile(
      "{\\n .reg .b64 pol;\\n"
      " createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"
      " ld.global.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], pol;\\n}\\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

"""


# variant -> ((file under src/repro_torch, ((old, new), ...)), ...)
_RNA = ("  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",)
_WS = "kernels/paper_suite.py"
PATCHES = {
    "eighths": ((_PM, (("  hash_rounds<HS_KG>(m, cta);",
                        "  hash_rounds<16>(m, cta);"),
                       ("#define HS_RG 8 ", "#define HS_RG 4 "))),),
    "no_tanh": ((_PM, ((_TANH4, "            a;"),)),),
    "no_combine": ((_PM, (_NO_COMBINE,)),),
    "loop_only": ((_PM, (
        _NO_COMBINE,
        ("      __syncthreads();\n      // the step's rows",
         "      // the step's rows"),
        ("      __syncthreads();\n    }\n  }\n  float* out",
         "    }\n  }\n  float* out"))),),
    "ethash_cvt": ((_PM, ((_RNA[0], "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 "
                           "%0, %1;\\n\" : \"=r\"(r) : \"f\"(v));\n  return r;"),)),),
    "ethash_trunc": ((_PM, (("  hi = tf32_rna(v);",
                             "  hi = __float_as_uint(v) & 0xffffe000u;"),)),),
    "ethash_no_tanh": ((_PM, (("tot[j][i] += tanhf(acc[j][i]);",
                               "tot[j][i] += acc[j][i];"),)),),
    "ethash_no_split": ((_PM, (("  hi = tf32_rna(v);\n  lo = tf32_rna(v - "
                                "__uint_as_float(hi));",
                                "  hi = __float_as_uint(v);\n  lo = hi;"),)),),
    "ethash_one_product": ((_PM, (
        ("for (int j = 0; j < 4; ++j) mma_tf32_1688(acc[j], al, bh[j]);",
         "for (int j = 0; j < 4; ++j) (void)al[j];"),
        ("for (int j = 0; j < 4; ++j) mma_tf32_1688(acc[j], ah, bl[j]);",
         "for (int j = 0; j < 4; ++j) (void)bl[j];"))),),
    "ethash_2acc": ((_PM, (
        ("    float acc[4][4];", "    float acc[4][4], acs[4][4];"),
        ("      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;\n#pragma unroll 2",
         "      for (int i = 0; i < 4; ++i) acc[j][i] = acs[j][i] = 0.f;\n"
         "#pragma unroll 2"),
        ("mma_tf32_1688(acc[j], al, bh[j]);", "mma_tf32_1688(acs[j], al, bh[j]);"),
        ("mma_tf32_1688(acc[j], ah, bl[j]);", "mma_tf32_1688(acs[j], ah, bl[j]);"),
        ("tot[j][i] += tanhf(acc[j][i]);",
         "tot[j][i] += tanhf(acc[j][i] + acs[j][i]);"))),),
    "ethash_unroll8": ((_PM, (("#pragma unroll 2\n    for (int p = 0;",
                               "#pragma unroll\n    for (int p = 0;"),)),),
    "ethash_256": ((_WS, (("max(1, 128 // max(1, bm // TILE_R))",
                           "max(1, 256 // max(1, bm // TILE_R))"),)),),
    "bnstats_tail16": ((_PM, (("#pragma unroll 8\n    for (int k = 0; k < n; "
                               "++k) {",
                               "#pragma unroll 16\n    for (int k = 0; k < n; "
                               "++k) {"),)),),
    "bnstats_unroll16": ((_PM, (("#define BN_UNROLL 8 ",
                                 "#define BN_UNROLL 16 "),)),),
    "bnstats_no_combine": ((_PM, (("  if (!hf_last_of_group(tickets, grp, "
                                   "in_grp)) return;",
                                   "  return;"),)),),
    "bnstats_4": ((_WS, (("BN_CTAS_PER_STEP = 8 ",
                          "BN_CTAS_PER_STEP = 4 "),)),),
    "bnstats_16": ((_WS, (("BN_CTAS_PER_STEP = 8 ",
                           "BN_CTAS_PER_STEP = 16 "),)),),
    "maxpool_cached": ((_PM, (
        ("        a[u] = __ldcs(x + (2 * r) * cv + c);\n        b[u] = "
         "__ldcs(x + (2 * r + 1) * cv + c);",
         "        a[u] = x[(2 * r) * cv + c];\n        b[u] = x[(2 * r + 1) * "
         "cv + c];"),
        ("      __stcs(out + v, ", "      *(out + v) = ("))),),
    "maxpool_ld_cs": ((_PM, (("      __stcs(out + v, ",
                              "      *(out + v) = ("),)),),
    "maxpool_st_cs": ((_PM, (
        ("        a[u] = __ldcs(x + (2 * r) * cv + c);\n        b[u] = "
         "__ldcs(x + (2 * r + 1) * cv + c);",
         "        a[u] = x[(2 * r) * cv + c];\n        b[u] = x[(2 * r + 1) * "
         "cv + c];"),)),),
    "hist_cached": ((_PM, (("    if (v < n) a[u] = __ldcs(x + v);",
                            "    if (v < n) a[u] = x[v];"),)),),
    "maxpool_policy": ((_PM, (
        ("__device__ __forceinline__ float ps_max(float a, float b) {",
         _POLICY_LD + "__device__ __forceinline__ float ps_max(float a, "
         "float b) {"),
        ("        a[u] = __ldcs(x + (2 * r) * cv + c);\n        b[u] = "
         "__ldcs(x + (2 * r + 1) * cv + c);",
         "        a[u] = ps_ld_ef(x + (2 * r) * cv + c);\n        b[u] = "
         "ps_ld_ef(x + (2 * r + 1) * cv + c);"))),),
    "hist_no_combine": ((_PM, (("  if (!hf_last_of_group(ticket, 0, m.ctas)) "
                                "return;", "  return;"),)),),
    "hist_2": ((_WS, (("HIST_CTAS_PER_STEP = 4 ",
                       "HIST_CTAS_PER_STEP = 2 "),)),),
    "hist_8": ((_WS, (("HIST_CTAS_PER_STEP = 4 ",
                       "HIST_CTAS_PER_STEP = 8 "),)),),
    "no_stream": (("csrc/bundle.cu", (
        ("  if (b.n == 1 && !(kinds & ~HF_KINDS_STREAM)) return HF_I_STREAM;\n",
         ""),)),),
    "hist_stream": (("csrc/bundle.cu", (
        ("#define HF_KINDS_STREAM HF_KIND(HF_MAXPOOL)",
         "#define HF_KINDS_STREAM (HF_KIND(HF_MAXPOOL) | HF_KIND(HF_HIST))"),
        )),),
    "maxpool_8": ((_WS, (("rows = bm // _per_step(bm, CTAS_PER_STEP, 2)",
                          "rows = bm // _per_step(bm, 8, 2)"),)),),
    "empty_body": ((_PM, (("__device__ void maxpool_member(const MemberDesc& "
                           "m, int cta) {\n",
                           "__device__ void maxpool_member(const MemberDesc& "
                           "m, int cta) {\n  if (cta >= 0) return;\n"),)),),
    "own_kernels": (("csrc/bundle.cu", (("}  // extern \"C\"\n",
                                         "}  // extern \"C\"\n" + _OWN),)),),
}
_UP_TMA = """__device__ void upsample_member(const MemberDesc& m, int cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = m.i[3];
  const unsigned rb = m.i[1] * (m.i[2] ? 4 : 2);        // bytes a row
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + rows * rb);
  if (threadIdx.x >= 32) return;
  const char* x = static_cast<const char*>(m.in[0]) + (size_t)cta * rows * rb;
  char* out = static_cast<char*>(m.out[0]) + (size_t)cta * 2 * rows * rb;
  if (threadIdx.x == 0) {
    hf_bar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    hf_bar_expect(bar, rows * rb);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\\n" ::"r"(hf_saddr(smem)), "l"(x),
        "r"(rows * rb), "r"(hf_saddr(bar)) : "memory");
  }
  __syncwarp();
  hf_bar_wait(bar, 0);
  for (int r = threadIdx.x; r < 2 * rows; r += 32)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
        ::"l"(out + (size_t)r * rb), "r"(hf_saddr(smem + (r / 2) * rb)),
        "r"(rb) : "memory");
  asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
}

"""
_IM_STAGED = r'''// im2col_staged: the CTA's rows staged in shared memory (cp.async); block
// by block, 16-byte output vectors from two aligned shared loads merged by
// funnel shifts (one load where s_k is a multiple of VEC), s_k = k < C ? k : 0
#define IM_UNROLL 8        // im2col: 16-byte stores a thread issues at once

// bytes [o, o + 16) of the 32 bytes a:b (little-endian; o even, < 16)
__device__ __forceinline__ uint4 ps_bytes16(uint4 a, uint4 b, int o) {
  if (o & 8) {
    a = make_uint4(a.z, a.w, b.x, b.y);
    b.x = b.z;
    b.y = b.w;
  }
  if (o & 4) {
    a = make_uint4(a.y, a.z, a.w, b.x);
    b.x = b.y;
  }
  const unsigned s = (o & 3) * 8;
  return make_uint4(__funnelshift_r(a.x, a.y, s), __funnelshift_r(a.y, a.z, s),
                    __funnelshift_r(a.z, a.w, s), __funnelshift_r(a.w, b.x, s));
}

template <typename T>
__device__ void im2col_staged(const MemberDesc& m, int cta) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);        // [rows][cv]
  const int C = m.i[1], rows = m.i[3], K = m.i[4];
  const int cv = C / VEC, n = rows * cv;             // vectors: a row, a block
  const uint4* x = static_cast<const uint4*>(m.in[0]) + (size_t)cta * n;
  uint4* out = static_cast<uint4*>(m.out[0]) + (size_t)cta * n * K;
  for (int v = threadIdx.x; v < n; v += HF_THREADS) cp_async16(xs + v, x + v, true);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int dr = HF_THREADS / cv, dc = HF_THREADS % cv;
  for (int k = 0; k < K; ++k) {
    const int s = k < C ? k : 0;
    const int q = s / VEC, o = s % VEC * (int)sizeof(T);
    int r = threadIdx.x / cv, c = threadIdx.x % cv;
    for (int v0 = threadIdx.x; v0 < n; v0 += IM_UNROLL * HF_THREADS) {
      uint4 val[IM_UNROLL];
      int at[IM_UNROLL];                 // offsets in the CTA's output
#pragma unroll
      for (int u = 0; u < IM_UNROLL; ++u) {
        if (v0 + u * HF_THREADS >= n) break;
        const uint4* row = xs + r * cv;
        const int a = c + q < cv ? c + q : c + q - cv;
        val[u] = row[a];
        if (o) val[u] = ps_bytes16(val[u], row[a + 1 < cv ? a + 1 : 0], o);
        at[u] = (r * K + k) * cv + c;
        r += dr;
        c += dc;
        if (c >= cv) { c -= cv; ++r; }
      }
#pragma unroll
      for (int u = 0; u < IM_UNROLL; ++u) {
        if (v0 + u * HF_THREADS >= n) break;
        out[at[u]] = val[u];
      }
    }
  }
}

__device__ void im2col_member(const MemberDesc& m, int cta) {
  if (m.i[2]) im2col_staged<float>(m, cta); else im2col_staged<bf16>(m, cta);
}

'''
_IM_MEMBER = ("__device__ void im2col_member(const MemberDesc& m, int cta) {\n"
              "  if (m.i[2]) im2col_rows<float>(m, cta); else "
              "im2col_rows<bf16>(m, cta);\n}")
_IM_SMEM = "    default: return 0;     // maxpool, upsample, im2col\n"
_UP_MEMBER = "__device__ void upsample_member(const MemberDesc& m, int cta) {\n"
_STREAM = "#define HF_KINDS_STREAM HF_KIND(HF_MAXPOOL)"
PATCHES.update({
    "upsample_tma": ((_PM, (
        (_UP_MEMBER, _UP_TMA + "__device__ void upsample_member_regs("
         "const MemberDesc& m, int cta) {\n"),
        (_IM_SMEM, "    case HF_UPSAMPLE: return m.i[3] * m.i[1] "
         "* (m.i[2] ? 4 : 2) + 16;\n" + _IM_SMEM))),),
    "upsample_ld_cs": ((_PM, (("      if (v < n) a[u] = x[v];",
                               "      if (v < n) a[u] = __ldcs(x + v);"),)),),
    "upsample_st_cs": ((_PM, (("      o[0] = a[u];\n      o[cv] = a[u];",
                               "      __stcs(o, a[u]);\n      __stcs(o + cv, "
                               "a[u]);"),)),),
    "upsample_stream": (("csrc/bundle.cu", ((
        _STREAM, "#define HF_KINDS_STREAM (HF_KIND(HF_MAXPOOL) | "
        "HF_KIND(HF_UPSAMPLE))"),)),),
    "im2col_staged": ((_PM, (
        (_IM_MEMBER, _IM_STAGED.rstrip("\n")),
        (_IM_SMEM, "    case HF_IM2COL: return m.i[3] * m.i[1] * (m.i[2] ? 4 "
         ": 2);\n" + _IM_SMEM))),),
})
PTXAS = {"hash_member": "11hash_member",
         "ethash_member": "13ethash_member", "hf_paper": "hf_paper",
         "hf_stream": "hf_stream",
         "mv_maxpool": "mv_maxpool", "mv_hist": "mv_hist"}
# --cases: name -> (factory, bf16, at SMALL_KW); "launch" is the launch cases
MEMBER_CASES = {
    "sha_like": ("sha_like", False, False),
    "blake_like": ("blake_like", False, False),
    "blake2b_like": ("blake2b_like", False, False),
    "ethash_like": ("ethash_like", False, False),
    "bnstats": ("bnstats", False, False),
    "bnstats_bf16": ("bnstats", True, False),
    "hist": ("hist", False, False), "hist_bf16": ("hist", True, False),
    "maxpool": ("maxpool", False, False),
    "maxpool_bf16": ("maxpool", True, False),
    "upsample": ("upsample", False, False),
    "upsample_bf16": ("upsample", True, False),
    "im2col": ("im2col", False, False),
    "im2col_bf16": ("im2col", True, False),
    "bnstats_small": ("bnstats", False, True),
}


def variant_root(name: str) -> Path:
    """A copy of ``src/repro_torch`` with the variant's patch applied; its
    library builds under the copy's own ``build/``."""
    root = ROOT / "build" / "member_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    pkg = root / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, edits in PATCHES[name]:
        path = pkg / rel
        text = path.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {rel} lacks {old!r}")
            text = text.replace(old, new)
        path.write_text(text)
    return root


def probe(root: Path, label: str, cases: list[str]) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.core import hfuse
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import cuda
    from repro_torch.kernels import paper_suite as ps

    use = cuda.ptxas_usage()
    for what, key in PTXAS.items():
        u = [v for k, v in use.items() if key in k]
        u = u[0] if u else {}
        print(f"[{label}] ptxas {what}: registers {u.get('registers', '-')}"
              f", spill stores {u.get('spill_stores', '-')} B, spill loads "
              f"{u.get('spill_loads', '-')} B", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(2222)
    flush = flush_buffer(dev)
    # a second of matrix products first, so the first case does not find
    # the card at its idle clocks
    a = torch.randn(4096, 4096, device=dev)
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
    del a
    for case in cases:
        if case == "launch":
            launch_cases(torch, label, g, flush)
            continue
        produced = case.endswith("_produced")
        consumed = case.endswith("_consumed")
        name, bf16, small = MEMBER_CASES[
            case.removesuffix("_produced").removesuffix("_consumed")]
        kw = dict(ps.SMALL_KW[name]) if small else {}
        if bf16:
            kw["dtype"] = torch.bfloat16
        op, mk, plain = ps.ALL_KERNELS[name](**kw)
        m = op.member
        ins = mk(g, dev)
        run = hfuse.run_single(op)
        if produced:
            produced_case(torch, label, case, run, ins, flush)
            continue
        if consumed:
            consumed_case(torch, label, case, op, run, ins, flush)
            continue
        err = (run(*ins)[0].float() - plain(*ins).float()).abs().max().item()
        ms = median_ms(lambda: run(*ins), flush)
        clean = flushed_ms(torch, lambda: run(*ins), flush)
        warm = flushed_ms(torch, lambda: run(*ins), None)
        if m.body == "ethash_like":      # three TF32 products
            b = max(3 * 2.0 * m.R * m.C * m.C / 495e12,
                    op.hbm_bytes / 3.35e12) * 1e3
        elif m.body == "hash_like":
            b = m.ops / 67e12 * 1e3
        else:
            b = op.hbm_bytes / 3.35e12 * 1e3
        rnd = (f", {ms / m.param * 1e3:.3f} us a round"
               if m.body == "hash_like" else "")
        print(f"[{label}] {case} ({op.ctas} CTAs): {ms:.4f} ms{rnd}, "
              f"{b / ms:.1%} of its bound {b:.4f} ms, max|err| {err:.3g} "
              f"(tolerance {ps.TOLERANCE[m.body]:g}); after a reading flush "
              f"{clean:.4f} ms, warm {warm:.4f} ms", flush=True)
        if name == "blake_like":
            clocks(label, lambda: run(*ins))


def produced_case(torch, label, case, run, ins, flush) -> None:
    """The member right after a producer that writes its first input
    (``x.copy_(src)``, src a copy of x): the pair and the producer alone,
    after a zeroing flush and warm, and the member's share (their
    difference)."""
    from repro_torch.core.timing import median_ms
    src = ins[0].clone()

    def copy():
        ins[0].copy_(src)

    def pair():
        ins[0].copy_(src)
        run(*ins)
    parts = []
    for what, timer in (("zeroing flush", lambda f: median_ms(f, flush)),
                        ("warm", lambda f: flushed_ms(torch, f, None))):
        both, alone = timer(pair), timer(copy)
        parts.append(f"{what}: producer + member {both:.4f} ms, producer "
                     f"{alone:.4f} ms, member {both - alone:.4f} ms")
    print(f"[{label}] {case}: " + "; ".join(parts), flush=True)


def consumed_case(torch, label, case, op, run, ins, flush) -> None:
    """upsample right before maxpool on its output, as a next layer reads
    it (maxpool(upsample(x)) is x: checked): the pair and maxpool alone (on
    a stored output), after a zeroing flush and warm."""
    from repro_torch.core import hfuse
    from repro_torch.core.timing import median_ms
    from repro_torch.kernels import paper_suite as ps
    m = op.member
    pool = hfuse.run_single(ps.make_maxpool(R=2 * m.R, C=m.C,
                                            dtype=m.dtype)[0])

    def consume(y):
        return pool(y)[0]
    if not torch.equal(consume(run(*ins)[0]), ins[0]):
        raise RuntimeError("maxpool(upsample(x)) is not x")
    stored = run(*ins)[0]

    def pair():
        consume(run(*ins)[0])
    parts = []
    for what, timer in (("zeroing flush", lambda f: median_ms(f, flush)),
                        ("warm", lambda f: flushed_ms(torch, f, None))):
        both, alone = timer(pair), timer(lambda: consume(stored))
        parts.append(f"{what}: member + consumer {both:.4f} ms, consumer "
                     f"alone {alone:.4f} ms")
    print(f"[{label}] {case}: " + "; ".join(parts), flush=True)


def launch_cases(torch, label, g, flush) -> None:
    """A paper launch's fixed cost taken apart: each case after a zeroing
    flush, after a reading flush and warm (see the module's docstring)."""
    import ctypes

    from repro_torch.core import hfuse
    from repro_torch.core.timing import median_ms
    from repro_torch.kernels import cuda
    from repro_torch.kernels import paper_suite as ps

    dev = flush.device
    lib = cuda.library()
    own = hasattr(lib, "mv_launch")
    if own:
        lib.mv_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
        lib.mv_launch.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    kept = []                       # descriptors, operands, workspaces

    def mv(which, desc, grid, smem):
        def call():
            err = lib.mv_launch(which, ctypes.byref(desc), grid, smem, stream)
            if err:
                raise RuntimeError(f"mv_launch {which}: error {err}")
        return call

    timed = [("empty event window", lambda: None)]
    for name, kw in (("maxpool", {}), ("maxpool", {"R": 1024}),
                     ("hist", {})):
        op, mk, _plain = ps.ALL_KERNELS[name](**kw)
        ins = mk(g, dev)
        run = hfuse.run_single(op)
        outs = [torch.empty(o.shape, dtype=o.dtype, device=dev)
                for o in op.outputs]
        inst = cuda.launch_instance([op.member], [ins], [outs])[0]
        timed.append((f"{name} {inst} {op.ctas} CTAs",
                      lambda run=run, ins=ins: run(*ins)))
        if not own or kw:
            continue
        desc, smem, held = cuda._describe([op.member], [ins], [outs], [1])
        kept.append((desc, ins, outs, held))
        timed.append((f"{name} body in its own kernel {op.ctas} CTAs",
                      mv(2 if name == "maxpool" else 3, desc, op.ctas, smem)))
    if own:
        desc = kept[0][0]
        for grid in (512, 64):
            timed += [(f"empty __global__ {grid} CTAs", mv(0, desc, grid, 0)),
                      (f"empty __global__ with the descriptor {grid} CTAs",
                       mv(1, desc, grid, 0))]
    for what, fn in timed:
        zero = median_ms(fn, flush)
        read = flushed_ms(torch, fn, flush)
        warm = flushed_ms(torch, fn, None)
        print(f"[{label}] launch {what}: zeroing flush {zero:.4f} ms, "
              f"reading flush {read:.4f} ms, warm {warm:.4f} ms", flush=True)


def clocks(label: str, fn, seconds: float = 2.0) -> None:
    """The SM clock and power draw (nvidia-smi, every 100 ms) while ``fn``
    runs back to back."""
    import torch
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()]
    mhz = [float(r[0]) for r in rows[2:] if len(r) == 2]
    watts = [float(r[1]) for r in rows[2:] if len(r) == 2]
    if mhz:
        print(f"[{label}] under blake_like back to back: SM clock median "
              f"{statistics.median(mhz):.0f} MHz (min {min(mhz):.0f}), power "
              f"median {statistics.median(watts):.1f} W", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The hash members and their variants, on the card.")
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--cases", default=",".join([*MEMBER_CASES, "launch"]),
                    help="member cases and/or 'launch' (default: all)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="turns of the tree and the variants, interleaved")
    ap.add_argument("--probe", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe:
        probe(Path(args.probe), args.label, args.cases.split(","))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    roots = {"as is": ROOT}
    roots.update((n, variant_root(n)) for n in args.variants.split(",") if n)
    builds = {label: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import cuda; cuda.build()",
         str(root / "src")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for label, root in roots.items()}
    for label, b in builds.items():
        out = b.communicate()[0]
        if b.returncode:
            print(f"[{label}] build failed:\n{out[-3000:]}", flush=True)
            if label == "as is":
                return 1
            del roots[label]
    order = list(roots) * args.rounds + ["as is"]
    for label in order:
        subprocess.run([sys.executable, __file__, "--probe",
                        str(roots[label]), "--label", label, "--cases",
                        args.cases], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
