#!/usr/bin/env python3
"""The tensor-core attention tile loop (``src/repro_torch/csrc/
attention_mma.cuh``) on the card, as it is and in source variants, at the
main path's shapes.

  python3 scripts/attention_variants.py [--variants single_p,inline_body,tkw32,no_prefill]

For the tree as it is, and for each variant built from a patched copy of
``src/repro_torch`` under ``build/attention_variants/<name>/``, in one
process each: ptxas's registers and spills of the bundle kernel's two
instances and the attention functions (chip_smoke's build report), then,
against the plain versions, flash attention (causal, 4 x 2048, 32/8 heads,
head dim 64 and 128) and the prefill attention member (C 512 at offsets 0
and 1024, the same heads): time (median of 20, CUDA events, L2 flushed),
max |err|, and whether chip_smoke's gates hold (``compare``, and
``FLASH_REL_BF16`` for flash); and the standalone rmsnorm, a row member
of the same bundle instance (8192 x 2048 bf16, PERF.md's row d), whose time
moves with that instance's register allocation.  The tree as it is also
times the member at 32, 64 and 128 rows a CTA (``ROWS_PER_CTA``, a
constant this diagnostic sets before each launch is packed).

Variants:
  single_p     P rounded once to bf16 for P.V (no p_lo term)
  inline_body  the member's body inlined into the bundle kernel
  tkw32        32 keys a warp's chunk at every head dim (64 at D <= 64)
  no_prefill   the bundle kernel without the prefill member's call (its
               prefill is not run): what the call costs the other members

Needs the card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATCHES = {
    "single_p": ("csrc/attention_mma.cuh", (
        ("            mma_bf16_16816(o[2 * d2], lo, b);\n", ""),
        ("            mma_bf16_16816(o[2 * d2 + 1], lo, b + 2);\n", ""))),
    "inline_body": ("csrc/prefill_attention.cuh", (
        ("__device__ __noinline__ void prefill_mma",
         "__device__ __forceinline__ void prefill_mma"),)),
    "tkw32": ("csrc/attention_mma.cuh", (
        ("return D <= 64 ? 64 : 32;", "return 32;"),)),
    "no_prefill": ("csrc/bundle.cu", (
        ("      HF_CASE(HF_PREFILL_ATTN, prefill_attn_member);\n", ""),)),
}


def variant_root(name: str) -> Path:
    """A copy of ``src/repro_torch`` with the variant's patch applied; its
    library builds under the copy's own ``build/``."""
    root = ROOT / "build" / "attention_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    pkg = root / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    rel, edits = PATCHES[name]
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
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.core import hfuse
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import prefill_attention as pa

    so = cuda.build()
    cuda.library()
    print(f"[{label}] {so}", flush=True)
    try:
        cs.build_report()
    except cs.PhaseError as e:      # no_prefill has no tensor-core member
        print(f"[{label}] build report: {e}", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1717)
    flush = flush_buffer(dev)

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def gate(got, want) -> str:
        try:
            cs.compare(torch, got, want)
        except cs.PhaseError as e:
            return f"FAIL ({e})"
        return "pass"

    x = randn((8192, 2048))
    scale = torch.randn((2048,), generator=g, device=dev) * 0.1
    ms = median_ms(lambda: ops.rmsnorm(x, scale), flush)
    print(f"[{label}] rmsnorm 8192x2048 bf16: {ms:.4f} ms", flush=True)
    del x
    for D in (64, 128):
        q = randn((4, 2048, 32, D))
        k, v = randn((4, 2048, 8, D)), randn((4, 2048, 8, D))
        got = fa.flash_attention_bshd(q, k, v)
        want = fa.plain_flash_attention_bshd(q, k, v)
        whole, row = cs.rel_l2_rows(torch, got, want)
        rel_ok = (whole <= cs.FLASH_REL_BF16[0]
                  and row <= cs.FLASH_REL_BF16[1])
        ms = median_ms(lambda: fa.flash_attention_bshd(q, k, v), flush)
        print(f"[{label}] flash causal 4x2048 H32/8 D{D}: {ms:.4f} ms, "
              f"max|err| {(got.float() - want.float()).abs().max().item():.3g}"
              f", rel L2 {whole:.3g}, worst row {row:.3g}; compare "
              f"{gate((got,), (want,))}, rel L2 gate "
              f"{'pass' if rel_ok else 'FAIL'}", flush=True)
        del q, k, v, got, want
        if label == "no_prefill":
            continue
        q = randn((cs.C, 32, D))
        kc, vc = randn((cs.S, 8, D)), randn((cs.S, 8, D))
        for rt in (32, 64, 128) if label == "as is" else (pa.ROWS_PER_CTA,):
            keep, pa.ROWS_PER_CTA = pa.ROWS_PER_CTA, rt
            op = pa.prefill_attention_op(cs.C, cs.S, 32, 8, D, ck=1024)
            run = hfuse.run_single(op)
            plain = hfuse.run_single(op, plain=True)
            for off in cs.PREFILL_OFFS:
                o = torch.full((1, 1), off, dtype=torch.int32, device=dev)
                got, want = run(o, q, kc, vc), plain(o, q, kc, vc)
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want))
                ms = median_ms(lambda: run(o, q, kc, vc), flush)
                print(f"[{label}] prefill C{cs.C} D{D} off {off}, {rt} rows "
                      f"a CTA ({op.ctas} CTAs): {ms:.4f} ms, max|err| "
                      f"{err:.3g}; fp32 gate {gate(got, want)}", flush=True)
            pa.ROWS_PER_CTA = keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The tensor-core attention tile loop and its variants "
                    "on the card.")
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--probe", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe:
        probe(Path(args.probe), args.label)
        return 0
    runs = [("as is", ROOT)] + [(n, variant_root(n))
                                for n in args.variants.split(",") if n]
    for label, root in runs:
        subprocess.run([sys.executable, __file__, "--probe", str(root),
                        "--label", label], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
