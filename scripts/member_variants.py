#!/usr/bin/env python3
"""The hash members on the card, as they are and in source variants, at the
paper suite's defaults.

  python3 scripts/member_variants.py [--variants loop_only,no_tanh,...]

For the tree as it is (first and last) and for each variant built from a
patched copy of ``src/repro_torch`` under ``build/member_variants/<name>/``
(all libraries built at once, then one process each, in turn): ptxas's
registers and spills of the hash body and ``hf_paper``; sha, blake and
blake2b (4096 x 128 fp32, 16 / 24 / 20 rounds) and ethash_like at their
defaults: time (median of 20, CUDA events, L2 flushed), microseconds a
round, share of the fp32 operation bound and max |err| against the plain
version; the SM clock and power draw under blake_like.

Variants (the last three give wrong outputs: they time what a part costs):
  eighths      the hash body with 16-deep k groups (eighths), 4 columns a
               lane, 16 rows a step, 4 rows at once: half the state bytes a
               fmaf, twice the partials
  no_tanh      the hash body without tanhf in its combine
  no_combine   the hash body without its combine, barriers kept
  loop_only    the hash body's loop alone: no combine, no barriers

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
}
PTXAS = {"hash_member": "11hash_member", "hf_paper": "hf_paper"}


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
    for name in ("sha_like", "blake_like", "blake2b_like", "ethash_like"):
        op, mk, plain = ps.ALL_KERNELS[name]()
        ins = mk(g, dev)
        run = hfuse.run_single(op)
        err = (run(*ins)[0] - plain(*ins)).abs().max().item()
        ms = median_ms(lambda: run(*ins), flush)
        b = op.member.ops / 67e12 * 1e3
        rnd = (f", {ms / op.member.param * 1e3:.3f} us a round"
               if name != "ethash_like" else "")
        print(f"[{label}] {name}: {ms:.4f} ms{rnd}, {b / ms:.1%} of its "
              f"bound {b:.4f} ms, max|err| {err:.3g} (tolerance "
              f"{ps.TOLERANCE[op.member.body]:g})", flush=True)
        if name == "blake_like":
            clocks(label, lambda: run(*ins))


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
