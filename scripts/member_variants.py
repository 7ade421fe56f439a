#!/usr/bin/env python3
"""The paper suite's matmul and reduction members on the card, as they are
and in source variants, at the paper suite's defaults.

  python3 scripts/member_variants.py [--variants loop_only,no_tanh,...]

For the tree as it is (first and last) and for each variant built from a
patched copy of ``src/repro_torch`` under ``build/member_variants/<name>/``
(all libraries built at once, then one process each, in turn): ptxas's
registers and spills of the hash and ethash bodies and ``hf_paper``; sha,
blake and blake2b (4096 x 128 fp32, 16 / 24 / 20 rounds), ethash_like,
bnstats (fp32 and bf16) and hist at their defaults, and bnstats at SMALL_KW
(its fixed cost): time (median of 20, CUDA events, L2 flushed by zeroing
a 256 MB buffer as ``core/timing.py`` does, and again after a flush that
reads it, which leaves L2 full of clean lines instead of dirty ones),
microseconds a round, share of the bound (the hash kernels' fp32
operations, ethash_like's three TF32 products, bnstats' and hist's bytes)
and max |err| against the plain version; the SM clock and power draw under
blake_like.

Variants (no_tanh, no_combine, loop_only, ethash_no_tanh and
bnstats_no_combine give wrong outputs: they time what a part costs):
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
_PM = "csrc/paper_member.cuh"
_TANH4 = ("            make_float4(tanhf(a.x), tanhf(a.y), tanhf(a.z), "
          "tanhf(a.w));")
_NO_COMBINE = ("      for (int u = 0; u < RV / HF_THREADS; ++u) {",
               "      for (int u = 0; u < 0; ++u) {")


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
}
PTXAS = {"hash_member": "11hash_member",
         "ethash_member": "13ethash_member", "hf_paper": "hf_paper"}


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


def probe(root: Path, label: str) -> None:
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
    cases = [(n, {}) for n in ("sha_like", "blake_like", "blake2b_like",
                               "ethash_like", "bnstats")]
    cases += [("bnstats", {"dtype": torch.bfloat16}), ("hist", {}),
              ("bnstats", ps.SMALL_KW["bnstats"])]
    for name, kw in cases:
        op, mk, plain = ps.ALL_KERNELS[name](**kw)
        m = op.member
        ins = mk(g, dev)
        run = hfuse.run_single(op)
        err = (run(*ins)[0] - plain(*ins)).abs().max().item()
        ms = median_ms(lambda: run(*ins), flush)
        clean = clean_ms(torch, lambda: run(*ins), flush)
        if m.body == "ethash_like":      # three TF32 products
            b = max(3 * 2.0 * m.R * m.C * m.C / 495e12,
                    op.hbm_bytes / 3.35e12) * 1e3
        elif m.body == "hash_like":
            b = m.ops / 67e12 * 1e3
        else:
            b = op.hbm_bytes / 3.35e12 * 1e3
        rnd = (f", {ms / m.param * 1e3:.3f} us a round"
               if m.body == "hash_like" else "")
        what = name + "".join(f" {k}={v}" for k, v in kw.items())
        print(f"[{label}] {what} ({op.ctas} CTAs): {ms:.4f} ms{rnd}, "
              f"{b / ms:.1%} of its bound {b:.4f} ms, max|err| {err:.3g} "
              f"(tolerance {ps.TOLERANCE[m.body]:g}); after a reading flush "
              f"{clean:.4f} ms", flush=True)
        if name == "blake_like":
            clocks(label, lambda: run(*ins))


def clean_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median ms of ``fn`` (CUDA events) after a flush that reads the
    buffer: L2 then holds clean lines, so the kernel's misses write nothing
    back (``median_ms`` zeroes it, leaving 50 MB of dirty lines).  A spin
    first keeps the queue ahead of the events, as in ``median_ms``."""
    from repro_torch.core.timing import SLEEP_CYCLES
    fn()
    torch.cuda.synchronize()
    times = []
    torch.cuda._sleep(SLEEP_CYCLES)
    for _ in range(reps):
        flush.sum()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


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
    ap.add_argument("--probe", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe:
        probe(Path(args.probe), args.label)
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
    order = list(roots) + ["as is"]
    for label in order:
        subprocess.run([sys.executable, __file__, "--probe",
                        str(roots[label]), "--label", label], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
